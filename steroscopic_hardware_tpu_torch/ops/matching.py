"""Binary descriptor matching on torch tensors (counterpart of
``ops/matching.py``: ``hamming_matrix``, ``match``, ``match_batch`` and
``match_one_to_many``).

With descriptors encoded as +/-1, ``dot(a, b) = n_bits - 2 * hamming``, so
one (Ka, 256) x (256, Kb) matrix product gives every pairwise distance.
The values are exact: the products are +/-1 and the partial sums integers
far inside float32's range. Ties are common, and ``torch.argmin`` returns
the first minimum, as ``jnp.argmin`` does. The batched forms match B sets
in one batched product and equal B separate ``match`` calls bit for bit.
"""

from __future__ import annotations

import torch

_INF = 1e9


def hamming_matrix(desc_a, desc_b, valid_a=None, valid_b=None):
    """Pairwise Hamming distances (..., Ka, Kb) float32 of (..., K, n_bits)
    uint8 descriptors in {0, 1}; rows / columns of invalid slots are
    _INF. Leading axes broadcast."""
    n_bits = desc_a.shape[-1]
    a = desc_a.to(torch.float32) * 2 - 1
    b = desc_b.to(torch.float32) * 2 - 1
    ham = (n_bits - a @ b.transpose(-1, -2)) / 2
    if valid_a is not None:
        ham = torch.where(valid_a[..., :, None], ham, _INF)
    if valid_b is not None:
        ham = torch.where(valid_b[..., None, :], ham, _INF)
    return ham


def _match_ham(ham, valid_a, ratio, max_distance):
    """Mutual nearest neighbours with a ratio test on a (..., Ka, Kb)
    distance matrix: (idx_b (..., Ka) int64, good (..., Ka) bool)."""
    rows = torch.arange(ham.shape[-2], device=ham.device)
    best_b = torch.argmin(ham, dim=-1)
    d1 = ham.amin(-1)
    # second best, for the ratio test
    ham2 = ham.scatter(-1, best_b[..., None], _INF)
    d2 = ham2.amin(-1)
    best_a_of_b = torch.argmin(ham, dim=-2)              # (..., Kb)
    mutual = torch.gather(best_a_of_b, -1, best_b) == rows
    good = (mutual & (d1 <= max_distance)
            & (d1 <= ratio * d2.clamp_min(1e-6)))
    if valid_a is not None:
        good = good & valid_a
    return best_b, good


def match(desc_a, desc_b, valid_a=None, valid_b=None, *, ratio: float = 0.8,
          max_distance: float = 64.0):
    """Mutual nearest neighbours with a ratio test.

    Returns (idx_b (Ka,) int64, the best match in b for each a; good (Ka,)
    bool, mutual, passing the ratio test and under max_distance).
    """
    ham = hamming_matrix(desc_a, desc_b, valid_a, valid_b)
    return _match_ham(ham, valid_a, ratio, max_distance)


def match_batch(descs_a, desc_b, valids_a, valid_b, *, ratio: float = 0.8,
                max_distance: float = 64.0):
    """B query sets (B, Ka, n_bits) against ONE target set in one batched
    product: (idx (B, Ka) into b, good (B, Ka)), equal to B separate
    ``match(a_i, b)`` calls. Loop-closure verification matches the top-k
    retrieved keyframes against the current one this way."""
    ham = hamming_matrix(descs_a, desc_b[None], valids_a, valid_b[None])
    return _match_ham(ham, valids_a, ratio, max_distance)


def match_one_to_many(desc_a, descs_b, valid_a, valids_b, *,
                      ratio: float = 0.8, max_distance: float = 64.0):
    """ONE query set against B target sets (B, Kb, n_bits): (idx (B, Ka)
    into each b_i, good (B, Ka)), equal to B separate ``match(a, b_i)``
    calls. The BA window build matches its anchor into every other window
    keyframe this way."""
    B = descs_b.shape[0]
    ham = hamming_matrix(desc_a[None], descs_b, valid_a[None], valids_b)
    return _match_ham(ham, valid_a[None].expand(B, -1), ratio, max_distance)
