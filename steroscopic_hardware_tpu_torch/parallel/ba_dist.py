"""Landmark-sharded bundle adjustment (counterpart of
``steroscopic_hardware_tpu/parallel/ba_dist.py``).

Every term of the Schur-reduced camera system is a sum over landmarks, so
each rank holds a block of the landmarks, forms its part of S and b, and
one all_reduce over the mesh axis gives every rank the whole system
(``models.ba.ba_solve(group=)``); each rank solves the same small 6M x 6M
pose system and back-substitutes its own landmarks.
"""

from __future__ import annotations

from steroscopic_hardware_tpu_torch.models.ba import BAProblem, ba_solve


def ba_solve_sharded(xi, points, uv, mask, *, intr: tuple, mesh,
                     iters: int = 10, axis_name: str = "rows"):
    """Windowed BA over this rank's landmark block: xi (M, 6) the same on
    every rank; points (N/n, 3), uv (M, N/n, 2) and mask (M, N/n) this
    rank's blocks of N landmarks (``multihost.shard``, which raises unless
    n divides N). Returns (xi (M, 6), this rank's points (N/n, 3), the
    per-iteration error over all landmarks (iters,))."""
    solved, errs = ba_solve(BAProblem(xi, points, uv, mask, intr),
                            iters=iters, group=mesh.get_group(axis_name))
    return solved.xi, solved.points, errs
