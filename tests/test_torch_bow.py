"""Parity of the port's loop-closure retrieval and matching with the JAX
package on the CPU: ``ops/bow.py`` (``BowIndex``) and the batched matches
of ``ops/matching.py`` (``match_batch``, ``match_one_to_many``).

* The packed seed-0 vocabulary equals the JAX draw
  ``jax.random.bernoulli(PRNGKey(0), 0.5, (256, 256))`` bit for bit.
* BoW vectors equal the JAX ``BowIndex.vector`` within VEC_TOL (the
  histogram counts are exact; only the normalization rounds).
* ``query`` order, ``before=``, ``min_score``, capacity growth, culling
  (``disable``), ``add_zero`` and concurrent use behave as
  ``tests/test_bow.py`` holds the JAX index, with the same retrieval lists.
* ``match_batch`` / ``match_one_to_many`` equal the JAX functions exactly
  (integer distances, first-minimum ties), on K <= 128 with duplicated
  rows and invalid slots.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu.ops import bow as jbow
from steroscopic_hardware_tpu.ops import matching as jm
from steroscopic_hardware_tpu_torch.ops import bow, matching

VEC_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: one intra-op thread (the suite runs several worker
    processes, and their thread teams would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _desc(rng, k=64):
    return (rng.integers(0, 2, (k, 256)).astype(np.uint8), np.ones(k, bool))


@pytest.fixture(scope="module")
def jax_index():
    return jbow.BowIndex()


def test_seed0_vocabulary_equals_jax_draw(jax_index):
    words = bow.vocabulary(0)
    want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(0), 0.5,
                                           (256, 256))).astype(np.float32)
    assert words.shape == (256, 256) and words.dtype == np.float32
    assert np.array_equal(words, want)
    assert np.array_equal(words, np.asarray(jax_index.words))
    assert np.array_equal(bow.BowIndex().words.numpy(), want)


def test_other_seed_and_explicit_words():
    w1 = bow.vocabulary(1)
    assert np.array_equal(w1, bow.vocabulary(1))  # seeded: reproducible
    assert not np.array_equal(w1, bow.vocabulary(0))
    assert set(np.unique(w1)) == {0.0, 1.0}
    ix = bow.BowIndex(words=w1)
    assert np.array_equal(ix.words.numpy(), w1)
    with pytest.raises(ValueError):
        bow.BowIndex(words=np.zeros((4, 256), np.float32))


def test_vectors_equal_jax(jax_index):
    rng = np.random.default_rng(1234)
    ix = bow.BowIndex()
    for k in (16, 64, 128):
        desc, valid = _desc(rng, k)
        valid[::3] = False
        got = ix.vector(desc, valid)
        want = jax_index.vector(desc, valid)
        assert got.dtype == np.float32 and got.shape == (256,)
        np.testing.assert_allclose(got, want, atol=VEC_TOL)
        assert np.linalg.norm(got) == pytest.approx(1.0, abs=1e-5)
    # no valid descriptor: the zero vector, as in JAX
    assert np.all(ix.vector(desc, np.zeros(k, bool)) == 0)


def test_query_order_before_and_min_score_as_jax():
    rng = np.random.default_rng(1234)
    ix, jix = bow.BowIndex(capacity=4), jbow.BowIndex(capacity=4)
    base, valid = _desc(rng, k=128)
    frames = [(base, valid)]
    for _ in range(10):  # growth past the capacity, twice
        frames.append(_desc(rng, k=128))
    for d, v in frames:
        assert ix.add(d, v) == jix.add(d, v)
    assert ix.n == 11
    noisy = base.copy()
    noisy[rng.random(noisy.shape) < 0.02] ^= 1
    for kw in (dict(top_k=3), dict(top_k=5, before=7), dict(top_k=1),
               dict(top_k=3, min_score=0.5), dict(top_k=3, before=0)):
        got = ix.query(noisy, valid, **kw)
        want = jix.query(noisy, valid, **kw)
        assert [i for i, _ in got] == [i for i, _ in want], kw
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                   atol=VEC_TOL)
    assert ix.query(noisy, valid, top_k=1)[0][0] == 0
    for i, (d, v) in enumerate(frames):  # every frame finds itself first
        hit = ix.query(d, v, top_k=1)[0]
        assert hit[0] == i and hit[1] == pytest.approx(1.0, abs=1e-5)
    assert bow.BowIndex().query(base, valid) == []  # empty index


def test_disable_add_zero_and_prequantized(jax_index):
    rng = np.random.default_rng(7)
    ix = bow.BowIndex()
    frames = [_desc(rng) for _ in range(4)]
    for d, v in frames:
        ix.add_vector(jax_index.vector(d, v))  # the fused tail's path
    assert ix.add_zero() == 4
    ix.disable(1)
    ix.disable(99)  # out of range: ignored
    hits = ix.query(*frames[1], top_k=5, min_score=0.05)
    assert 1 not in [i for i, _ in hits]
    assert 4 not in [i for i, _ in hits]
    vec = ix.vector(*frames[2])
    assert ix.query_vector(vec, top_k=1)[0][0] == 2
    assert ix.warmup(32) == 3


def test_concurrent_add_and_query():
    """A writer appending (with growth) while a reader queries: no error,
    no index past the snapshot (tests/test_bow.py's invariant)."""
    rng = np.random.default_rng(3)
    ix = bow.BowIndex(capacity=4)
    descs = [rng.integers(0, 2, (64, 256)).astype(np.uint8)
             for _ in range(30)]
    valid = np.ones(64, bool)
    errs = []

    def writer():
        try:
            for d in descs:
                ix.add(d, valid)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    t = threading.Thread(target=writer)
    t.start()
    try:
        for _ in range(30):
            for j, _score in ix.query(descs[0], valid, top_k=3):
                assert 0 <= j < ix.n
    finally:
        t.join(timeout=30)
    assert not t.is_alive() and not errs
    assert ix.n == len(descs)


def _sets(rng, B, k):
    """B noisy permuted copies of one descriptor set, with duplicated rows
    (argmin ties) and invalid slots."""
    a = rng.integers(0, 2, (k, 256), dtype=np.uint8)
    a[k // 2: k // 2 + 4] = a[0]
    out = []
    for _ in range(B):
        b = a[rng.permutation(k)] ^ (rng.random((k, 256)) < 0.1).astype(
            np.uint8)
        b[: k // 8] = rng.integers(0, 2, (k // 8, 256), dtype=np.uint8)
        out.append(b)
    return a, np.stack(out), rng.random(k) < 0.9, rng.random((B, k)) < 0.9


@pytest.mark.parametrize("B,k,ratio,max_distance", [
    (1, 64, 0.85, 60.0), (4, 128, 0.85, 60.0), (3, 96, 0.9, 80.0)])
def test_batched_matches_equal_jax(B, k, ratio, max_distance):
    rng = np.random.default_rng(B * k)
    a, bs, va, vbs = _sets(rng, B, k)
    t = torch.from_numpy
    kw = dict(ratio=ratio, max_distance=max_distance)
    # loop-closure verification: B candidates against the current set
    idx, good = matching.match_batch(t(bs), t(a), t(vbs), t(va), **kw)
    widx, wgood = jm.match_batch(bs, a, vbs, va, **kw)
    assert idx.shape == good.shape == (B, k)
    assert np.array_equal(idx.numpy(), np.asarray(widx))
    assert np.array_equal(good.numpy(), np.asarray(wgood))
    assert good.any() and not good.all()
    # the window build: one anchor against B keyframes
    idx, good = matching.match_one_to_many(t(a), t(bs), t(va), t(vbs), **kw)
    widx, wgood = jm.match_one_to_many(a, bs, va, vbs, **kw)
    assert np.array_equal(idx.numpy(), np.asarray(widx))
    assert np.array_equal(good.numpy(), np.asarray(wgood))
    # each row is the single match
    for i in range(B):
        one = matching.match(t(a), t(bs[i]), t(va), t(vbs[i]), **kw)
        assert np.array_equal(one[0].numpy(), idx[i].numpy())
        assert np.array_equal(one[1].numpy(), good[i].numpy())
