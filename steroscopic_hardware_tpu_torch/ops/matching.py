"""Binary descriptor matching on torch tensors (counterpart of
``ops/matching.py``: ``hamming_matrix`` and ``match``).

With descriptors encoded as +/-1, ``dot(a, b) = n_bits - 2 * hamming``, so
one (Ka, 256) x (256, Kb) matrix product gives every pairwise distance.
The values are exact: the products are +/-1 and the partial sums integers
far inside float32's range. Ties are common, and ``torch.argmin`` returns
the first minimum, as ``jnp.argmin`` does.
"""

from __future__ import annotations

import torch

_INF = 1e9


def hamming_matrix(desc_a, desc_b, valid_a=None, valid_b=None):
    """Pairwise Hamming distances (Ka, Kb) float32 of (K, n_bits) uint8
    descriptors in {0, 1}; rows / columns of invalid slots are _INF."""
    n_bits = desc_a.shape[-1]
    a = desc_a.to(torch.float32) * 2 - 1
    b = desc_b.to(torch.float32) * 2 - 1
    ham = (n_bits - a @ b.T) / 2
    if valid_a is not None:
        ham = torch.where(valid_a[:, None], ham, _INF)
    if valid_b is not None:
        ham = torch.where(valid_b[None, :], ham, _INF)
    return ham


def match(desc_a, desc_b, valid_a=None, valid_b=None, *, ratio: float = 0.8,
          max_distance: float = 64.0):
    """Mutual nearest neighbours with a ratio test.

    Returns (idx_b (Ka,) int64, the best match in b for each a; good (Ka,)
    bool, mutual, passing the ratio test and under max_distance).
    """
    ham = hamming_matrix(desc_a, desc_b, valid_a, valid_b)
    rows = torch.arange(ham.shape[0], device=ham.device)
    best_b = torch.argmin(ham, dim=1)
    d1 = ham.amin(1)
    # second best, for the ratio test
    ham2 = ham.clone()
    ham2[rows, best_b] = _INF
    d2 = ham2.amin(1)
    mutual = torch.argmin(ham, dim=0)[best_b] == rows
    good = (mutual & (d1 <= max_distance)
            & (d1 <= ratio * d2.clamp_min(1e-6)))
    if valid_a is not None:
        good = good & valid_a
    return best_b, good
