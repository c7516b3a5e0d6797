"""Edge-sharded pose-graph optimization (counterpart of
``steroscopic_hardware_tpu/parallel/pg_dist.py``).

A pose graph grows by its edges (a sequential edge per keyframe, one per
loop closure) while the node state stays small (M x 6 twists). Each rank
holds a block of the edges and scatters its edges' terms of the gradient,
the block-Jacobi preconditioner and every CG product; one all_reduce per
quantity gives every rank the whole value, and each rank runs the same CG
(``models.slam.pose_graph_optimize(group=)``). Padded edges have weight
0, so only the padded edge count must divide by the axis size.
"""

from __future__ import annotations

import numpy as np

from steroscopic_hardware_tpu_torch.models.slam import pose_graph_optimize


def pose_graph_optimize_sharded(xi_nodes, edges_shard, meas_shard, w_shard,
                                *, mesh, iters: int = 15,
                                damping: float = 1e-4, fix_first: bool = True,
                                cg_iters: int = 100, axis_name: str = "rows"):
    """Pose-graph Gauss-Newton with the nodes (M, 6) the same on every rank
    and this rank's blocks of the E edges, measurements and weights
    (``multihost.shard`` of :func:`pad_edges`' arrays). Returns (xi
    (M, 6), the per-iteration costs over all edges (iters,))."""
    return pose_graph_optimize(
        xi_nodes, edges_shard, meas_shard, w_shard, iters=iters,
        damping=damping, fix_first=fix_first, cg_iters=cg_iters,
        group=mesh.get_group(axis_name))


def pad_edges(edges_ij, xi_meas, weights, n: int):
    """Pad an edge set with inert (weight-0, node-0) edges so E divides by
    ``n``. numpy in and out (a copy of the JAX package's host helper)."""
    E = len(edges_ij)
    Ep = -(-E // n) * n
    if Ep == E:
        return edges_ij, xi_meas, weights
    pad = Ep - E
    edges_ij = np.concatenate(
        [edges_ij, np.zeros((pad, 2), edges_ij.dtype)])
    xi_meas = np.concatenate([xi_meas, np.zeros((pad, 6), xi_meas.dtype)])
    weights = np.concatenate([weights, np.zeros(pad, weights.dtype)])
    return edges_ij, xi_meas, weights
