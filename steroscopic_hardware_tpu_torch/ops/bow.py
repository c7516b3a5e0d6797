"""Binary bag-of-words place recognition for loop closure (counterpart of
``ops/bow.py``): ``_bow_vector``, ``_scores`` and ``BowIndex``.

* A fixed random binary vocabulary of 256 words of 256 bits: random words
  are near-orthogonal in Hamming space, so no training pass is needed.
* ``_bow_vector``: each valid ORB descriptor is quantized to its nearest
  word (one (K, 256) x (256, V) product gives every Hamming distance:
  ham = |d| + |w| - 2 d.w, exact integers in float32; ties go to the first
  word) and the term-frequency histogram is L2-normalized.
* ``BowIndex``: an append-only table of keyframe vectors; a query scores
  the whole history with one (N, V) x (V,) product (cosine similarity of
  unit vectors). The table lives on the device in a capacity-doubling
  buffer, with a host mirror that is the source of truth.

The JAX vocabulary is ``jax.random.bernoulli(PRNGKey(seed), 0.5, (256,
256))``. The port cannot draw it without JAX, so the seed-0 vocabulary
(the one ``StereoSLAM`` and the fused tail use) ships bit-packed in
``bow_words_seed0.bin`` (8 KB, ``np.packbits`` along the bits), and BoW
vectors, retrieval order and checkpoints agree with the JAX package.
Another seed draws its words from a ``torch.Generator``: a different
vocabulary from the JAX package's for that seed. ``words=`` gives one
explicitly.

Thread safety: a lock guards the host mirror, the table's row writes and
the snapshot of the row count; the products run outside it. Rows are
written on the writer's CUDA stream and a query may run on another (the
asynchronous SLAM backend's), so every write records a CUDA event and a
query's stream waits on the newest one before it reads the table.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

WORDS_SEED0 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "bow_words_seed0.bin")


def vocabulary(seed: int = 0, n_words: int = 256,
               desc_bits: int = 256) -> np.ndarray:
    """(n_words, desc_bits) float32 words in {0, 1}: the JAX package's
    seed-0 draw from the packed file, else a ``torch.Generator`` draw."""
    if seed == 0 and (n_words, desc_bits) == (256, 256):
        packed = np.fromfile(WORDS_SEED0, dtype=np.uint8)
        return np.unpackbits(packed.reshape(256, 32), axis=1).astype(
            np.float32)
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, 2, (n_words, desc_bits), generator=gen).to(
        torch.float32).numpy()


def _bow_vector(desc, valid, words):
    """L2-normalized term-frequency vector (V,) float32 of (K, 256) uint8
    descriptors in {0, 1} with their (K,) validity, over (V, 256) float32
    ``words``; zeros where no descriptor is valid."""
    d = desc.to(torch.float32)                          # (K, 256)
    dots = d @ words.T                                  # (K, V)
    ham = d.sum(1, keepdim=True) + words.sum(1)[None, :] - 2.0 * dots
    w_idx = torch.argmin(ham, dim=1)                    # (K,)
    tf = torch.zeros(words.shape[0], dtype=torch.float32,
                     device=desc.device).index_add_(
        0, w_idx, valid.to(torch.float32))
    return tf / torch.linalg.norm(tf).clamp_min(1e-9)


def _scores(db, q, n):
    """Cosine similarity of q against the first ``n`` rows of the padded
    table: one product for the whole history, -inf past row n."""
    s = db @ q
    live = torch.arange(db.shape[0], device=db.device) < n
    return torch.where(live, s, float("-inf"))


class BowIndex:
    """Append-only place-recognition table over keyframe descriptors.

    Args:
      n_words, desc_bits: vocabulary size and descriptor bits.
      seed: the vocabulary's seed (0: the JAX package's vocabulary).
      capacity: initial rows of the device table (doubles when full).
      words: an explicit (n_words, desc_bits) {0, 1} vocabulary.
      device: the table's and the products' device ("cuda" or "cpu").
    """

    def __init__(self, n_words: int = 256, desc_bits: int = 256,
                 seed: int = 0, capacity: int = 64, words=None,
                 device="cpu"):
        self.device = torch.device(device)
        if words is None:
            words = vocabulary(seed, n_words, desc_bits)
        words = np.asarray(words, np.float32)
        if words.shape != (n_words, desc_bits):
            raise ValueError(f"words of shape {words.shape}, expected "
                             f"{(n_words, desc_bits)}")
        self.words = torch.from_numpy(words).to(self.device)
        self.n_words = n_words
        self.seed = seed
        self._db = np.zeros((capacity, n_words), np.float32)  # host mirror
        self._db_dev = None
        self._written = None  # CUDA event after the newest table write
        self.n = 0
        self._mu = threading.Lock()

    def _tensor(self, a, dtype=None):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.array(a))
        return t.to(self.device, dtype=dtype)

    def vector(self, desc, valid) -> np.ndarray:
        return _bow_vector(self._tensor(desc), self._tensor(valid),
                           self.words).cpu().numpy()

    def add(self, desc, valid) -> int:
        """Quantize and append one keyframe; returns its index."""
        return self.add_vector(self.vector(desc, valid))

    def _ensure_dev(self):
        """The device table (caller holds ``_mu``), rebuilt from the mirror
        only after a capacity doubling."""
        if self._db_dev is None or self._db_dev.shape[0] != len(self._db):
            self._db_dev = torch.from_numpy(self._db.copy()).to(self.device)
            self._mark_written()
        return self._db_dev

    def _mark_written(self):
        if self.device.type == "cuda":
            self._written = torch.cuda.Event()
            self._written.record(torch.cuda.current_stream(self.device))

    def _set_row(self, i: int, vec: np.ndarray):
        """Write row i of the mirror and of the device table (caller holds
        ``_mu``). Only row n (beyond every query's snapshot) or a disabled
        row changes, so a concurrent query reads a consistent table."""
        self._db[i] = vec
        if self._db_dev is not None:
            self._db_dev[i].copy_(self._tensor(vec))
            self._mark_written()

    def _append_row(self, vec: np.ndarray) -> int:
        if self.n == len(self._db):
            grown = np.zeros((2 * len(self._db), self.n_words), np.float32)
            grown[: self.n] = self._db
            self._db = grown
            self._db_dev = None  # re-uploaded with the new row below
        self._ensure_dev()
        self._set_row(self.n, vec)
        self.n += 1
        return self.n - 1

    def add_vector(self, vec) -> int:
        """Append a pre-quantized place vector (e.g. the fused serve+track
        tail's, ``runtime/fused.py``); returns its index."""
        with self._mu:
            return self._append_row(np.asarray(vec, np.float32))

    def add_zero(self) -> int:
        """Append an inert zero row: keeps rows aligned with keyframes when
        a checkpoint's old keyframes were feature-culled."""
        with self._mu:
            return self._append_row(np.zeros(self.n_words, np.float32))

    def disable(self, idx: int) -> None:
        """Retire a stored keyframe: zero its row so it scores 0 against
        every query. Used by keyframe feature culling."""
        with self._mu:
            if 0 <= idx < self.n:
                self._set_row(idx, np.zeros(self.n_words, np.float32))

    def warmup(self, n_desc: int) -> int:
        """Run the quantize product and the score product once for
        ``n_desc`` descriptors at the current capacity (the first use of
        the device's BLAS handles and memory pool); returns 3, the JAX
        count of programs (quantize, score, row write)."""
        desc = torch.zeros((n_desc, self.words.shape[1]), dtype=torch.uint8,
                           device=self.device)
        q = _bow_vector(desc, torch.zeros(n_desc, dtype=torch.bool,
                                          device=self.device), self.words)
        with self._mu:
            db = self._ensure_dev()
            self._wait_written()
        _scores(db, q, 0).cpu()
        return 3

    def _wait_written(self):
        if self._written is not None:
            torch.cuda.current_stream(self.device).wait_event(self._written)

    def query(self, desc, valid, *, top_k: int = 3, min_score: float = 0.0,
              before: int | None = None):
        """Top-k most similar stored keyframes: a list of (index, score),
        best first. ``before`` restricts candidates to indices < before
        (the loop gap)."""
        q = _bow_vector(self._tensor(desc), self._tensor(valid), self.words)
        return self.query_vector(q, top_k=top_k, min_score=min_score,
                                 before=before)

    def query_vector(self, vec, *, top_k: int = 3, min_score: float = 0.0,
                     before: int | None = None):
        """Top-k retrieval for a pre-quantized place vector (the contract
        of :meth:`query`), scored against the device table."""
        with self._mu:
            n = self.n if before is None else min(before, self.n)
            db = self._ensure_dev()  # replaced on growth, so safe to read
            self._wait_written()
        if n <= 0:
            return []
        s = _scores(db, self._tensor(vec, torch.float32), n).cpu().numpy()[:n]
        order = np.argsort(-s)[:top_k]
        return [(int(i), float(s[i])) for i in order if s[i] >= min_score]
