"""Scanline-sharded SGM over the ranks of a mesh axis (counterpart of
``steroscopic_hardware_tpu/parallel/sgm_shard.py``).

Every vertical path lies inside one column and every horizontal path
inside one row, so the exact n-way split needs no halo: rank i aggregates
the vertical family over its W-band of columns and the horizontal family
over its H-band of rows, one ``all_to_all`` reshards the horizontal
aggregate from H-bands to W-bands, and each rank runs the epilogue on its
W-band. Per rank and frame that is the single-process fused chain at 1/n
of its size: B4 (``sgm_transpose_add``) once on the W-band's cost volume,
B3 (``sgm_aggregate``) on it and on the H-band's, and B5
(``sgm_epilogue``) once; the map is bit for bit the single-process
``sgm_disparity(..., epilogue="fused")``, the aggregates being exact small
integers in every storage tier. B5 needs none of the JAX function's
128-column padding.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from steroscopic_hardware_tpu_torch.ops.census import _cost_volume, census5x5
from steroscopic_hardware_tpu_torch.ops.sgm import (
    _bf16_exact,
    _u8_exact,
    aggregate_axis,
    sgm_epilogue,
    transpose_add,
)
from steroscopic_hardware_tpu_torch.parallel.multihost import all_to_all


def band_volumes_T(left, right, max_disparity: int, i: int, n: int):
    """Rank i's two band volumes of the transposed frame, from the whole
    (H, W) pair: ``cost_w`` (D + 1, W/n, H) over columns [i W/n, (i + 1)
    W/n) for the vertical family and ``cost_h`` (D + 1, W, H/n) over rows
    [i H/n, (i + 1) H/n) for the horizontal one (JAX ``_band_volumes_T``:
    the census codes of the whole frame, then only 2/n of the volume)."""
    cl, cr = census5x5(left.T), census5x5(right.T)  # (W, H) int32
    W, H = cl.shape
    wn, hn = W // n, H // n
    cost_w = _cost_volume(cl, cr, max_disparity, axis=0, x0=i * wn,
                          width=wn)
    rows = slice(i * hn, (i + 1) * hn)
    cost_h = _cost_volume(cl[:, rows], cr[:, rows], max_disparity, axis=0)
    return cost_w, cost_h


def sgm_disparity_sharded(left: torch.Tensor, right: torch.Tensor, *,
                          max_disparity: int, P1: float = 1.0,
                          P2: float = 8.0, subpixel: bool = True, mesh,
                          axis_name: str = "rows") -> torch.Tensor:
    """float32 (H, W/n) SGM disparity of this rank's W-band of the whole
    (H, W) pair given to every rank; ``multihost.all_gather(..., dim=1)``
    joins the bands into the single-process map, bit for bit. Raises
    ValueError unless the axis size n divides H and W."""
    group = mesh.get_group(axis_name)
    n, i = dist.get_world_size(group), dist.get_rank(group)
    H, W = left.shape
    if H % n or W % n:
        raise ValueError(
            f"H={H} and W={W} must divide by mesh axis {axis_name}={n}")
    P1, P2 = float(P1), float(P2)
    # the single-process tier ladder: uint8 aggregates when exact (a
    # quarter of float32's all_to_all bytes), else bfloat16, else float32
    if _u8_exact(P1, P2):
        agg_dtype = torch.uint8
    elif _bf16_exact(P1, P2):
        agg_dtype = torch.bfloat16
    else:
        agg_dtype = torch.float32
    cost_w, cost_h = band_volumes_T(left, right, max_disparity, i, n)
    # vertical family on the W-band, in the (D, H, W/n) frame
    cost_v = transpose_add(cost_w, out_dtype=torch.bfloat16)
    del cost_w
    agg_v = aggregate_axis(cost_v, P1, P2, out_dtype=agg_dtype)
    del cost_v
    # horizontal family on the H-band, in the transposed (D, W, H/n) frame
    agg_ht = aggregate_axis(cost_h, P1, P2, out_dtype=agg_dtype)
    del cost_h
    # reshard H-bands -> W-bands: column block j goes to rank j, and the
    # row blocks that come back stack along H in rank order
    D1, _, hn = agg_ht.shape
    wn = W // n
    blocks = agg_ht.view(D1, n, wn, hn).transpose(0, 1)   # (n, D, wn, hn)
    got = all_to_all(blocks, group, tag="all_to_all")
    agg_htw = got.permute(1, 2, 0, 3).reshape(D1, wn, H)  # (D, wn, H)
    return sgm_epilogue(agg_v, agg_htw, subpixel=subpixel)
