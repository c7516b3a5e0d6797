"""Semi-global matching (SGM) disparity: the plain torch versions and the
kernel wrappers (counterpart of ``ops/sgm.py``).

Census Hamming costs are aggregated along the 4 scanline directions with
the P1/P2 smoothness recursion

  L_r(p, d) = C(p, d) + min(L_r(p-r, d), L_r(p-r, d+-1) + P1,
                            min_d' L_r(p-r, d') + P2) - min_d' L_r(p-r, d')

(d outside [0, D) counts as +INF; each direction starts from L = C), then
a first-minimum argmin over d with an optional parabola subpixel step.

The chain is the JAX package's TPU chain (``_sgm_impl``, ``_sgm_lr_impl``):
the cost volume is built in the transposed (D, W, H) frame, B4 transposes
it to the (D, H, W) frame, B3 aggregates the vertical paths on the latter
and the horizontal paths on the former (both along axis 1), and either B4
sums the two aggregates for the plain-torch epilogue ("unfused") or B5
does transpose-add, argmin and parabola in one pass ("fused"). The storage
tiers are the JAX package's: integer penalties keep every stored value an
exact small integer, so uint8 / bfloat16 storage gives the same
disparities as float32, and kernel, plain version and JAX package agree
exactly.

Each kernel has a plain version and a wrapper beside it:

* ``aggregate_axis`` / ``aggregate_axis_plain`` (B3,
  ``_aggregate_axis_pallas``; the plain version also covers the XLA
  ``_aggregate_axis`` along either axis);
* ``transpose_add`` / ``transpose_add_plain`` (B4,
  ``_transpose_add_pallas``);
* ``sgm_epilogue`` / ``sgm_epilogue_plain`` (B5, ``_sgm_epilogue_pallas``).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel of ``csrc/sgm.cu`` or raises.
"""

from __future__ import annotations

import torch

from steroscopic_hardware_tpu_torch import _kernels
from steroscopic_hardware_tpu_torch.ops.census import census_cost_volume_T
from steroscopic_hardware_tpu_torch.ops.sad import _uses_plain

INF = 1e9  # the JAX package's _INF: never wins a min over real costs


# -- storage tiers (the JAX package's gates, unchanged) -----------------------

def _bf16_exact(P1: float, P2: float) -> bool:
    """Per-path values (integers <= 24 + P2) and their fwd+bwd sums
    (<= 2 * (24 + P2) <= 256) are exact in bfloat16."""
    return (float(P1).is_integer() and float(P2).is_integer()
            and 0 <= P1 and 0 <= P2 <= 104)


def _u8_exact(P1: float, P2: float) -> bool:
    """Per-path values <= 127 and fwd+bwd sums <= 254 fit uint8."""
    return (float(P1).is_integer() and float(P2).is_integer()
            and 0 <= P1 <= 103 and 0 <= P2 <= 103)


def _bf16_sum_exact(P1: float, P2: float) -> bool:
    """The 4-path summed volume (<= 4 * (24 + P2) <= 256) is exact in
    bfloat16."""
    return (float(P1).is_integer() and float(P2).is_integer()
            and 0 <= P1 and 0 <= P2 <= 40)


# -- B3: aggregation along one axis -------------------------------------------

def _store(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Narrow a float32 path value to its storage type (uint8 through
    int32, truncating, as the TPU kernel stores it)."""
    if dtype == torch.uint8:
        return x.to(torch.int32).to(torch.uint8)
    return x.to(dtype)


def aggregate_axis_plain(cost: torch.Tensor, P1: float, P2: float, *,
                         axis: int = 1,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Forward + backward SGM aggregation of a (D, H, W) cost volume
    (uint8 / bfloat16 / float32) along ``axis`` (1: vertical paths, 2:
    horizontal ones). The recursion runs in float32 in the operation
    order of the TPU kernel; each direction is stored in ``out_dtype``
    and the two are added in it (uint8 widened to int32 and narrowed)."""
    vol = cost.movedim(axis, 0).to(torch.float32)     # (S, D, K)
    S = vol.shape[0]
    # both directions batched: [0] forward, [1] backward
    prev = torch.stack([vol[0], vol[S - 1]])          # (2, D, K)
    fwd = torch.empty(vol.shape, dtype=out_dtype, device=vol.device)
    bwd = torch.empty_like(fwd)
    fwd[0] = _store(prev[0], out_dtype)
    bwd[S - 1] = _store(prev[1], out_dtype)
    inf_row = torch.full_like(prev[:, :1], INF)
    for s in range(1, S):
        c = torch.stack([vol[s], vol[S - 1 - s]])
        m = prev.amin(dim=1, keepdim=True)
        up = torch.cat([prev[:, 1:], inf_row], 1)
        dn = torch.cat([inf_row, prev[:, :-1]], 1)
        best = torch.minimum(torch.minimum(prev, torch.minimum(up, dn) + P1),
                             m + P2)
        prev = (c + best) - m
        fwd[s] = _store(prev[0], out_dtype)
        bwd[S - 1 - s] = _store(prev[1], out_dtype)
    if out_dtype == torch.uint8:
        both = (fwd.to(torch.int32) + bwd.to(torch.int32)).to(torch.uint8)
    else:
        both = fwd + bwd
    return both.movedim(0, axis)


def aggregate_axis(cost: torch.Tensor, P1: float, P2: float, *,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """Forward + backward aggregation of a (D, S, K) cost volume along S
    (axis 1), in ``out_dtype`` (the ``_aggregate_axis_pallas`` counterpart,
    d-major)."""
    if _uses_plain(cost):
        return aggregate_axis_plain(cost, P1, P2, axis=1, out_dtype=out_dtype)
    return _kernels.sgm_aggregate(cost, P1, P2, out_dtype)


# -- B4: transpose-add --------------------------------------------------------

def transpose_add_plain(aT: torch.Tensor, b: torch.Tensor | None = None, *,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """``aT.transpose(1, 2) [+ b]`` widened to float32, stored in
    ``out_dtype``: aT (D, B, A), b (D, A, B) -> (D, A, B)."""
    out = aT.transpose(1, 2).to(torch.float32)
    if b is not None:
        out = b.to(torch.float32) + out
    return out.to(out_dtype)


def transpose_add(aT: torch.Tensor, b: torch.Tensor | None = None, *,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """``_transpose_add_pallas`` counterpart (d-major)."""
    if _uses_plain(aT, *([] if b is None else [b])):
        return transpose_add_plain(aT, b, out_dtype=out_dtype)
    return _kernels.sgm_transpose_add(aT, b, out_dtype)


# -- epilogues ----------------------------------------------------------------

def argmin_first(agg: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """First-minimum argmin over ``dim`` (torch documents that argmin
    returns the first of equal minima), as int64."""
    return agg.argmin(dim=dim)


def epilogue(agg: torch.Tensor, subpixel: bool) -> torch.Tensor:
    """Argmin + optional parabola over a summed (D, H, W) volume ->
    float32 (H, W) (the ``_epilogue_xla`` counterpart; gathers where the
    TPU used masked reductions, the same values)."""
    D = agg.shape[0]
    d_best = argmin_first(agg)
    if not subpixel or D < 3:  # below 3 planes no d lies in [1, D - 2]
        return d_best.to(torch.float32)
    d_c = d_best.clamp(1, D - 2)
    c0, c1, c2 = (agg.gather(0, (d_c + k)[None])[0].to(torch.float32)
                  for k in (-1, 0, 1))
    denom = (c0 - 2 * c1 + c2).clamp(min=1e-6)
    delta = (0.5 * (c0 - c2) / denom).clamp(-0.5, 0.5)
    return torch.where((d_best >= 1) & (d_best <= D - 2),
                       d_c.to(torch.float32) + delta,
                       d_best.to(torch.float32))


_epilogue = epilogue  # sgm_disparity's ``epilogue`` argument shadows the name


def sgm_epilogue_plain(agg_v: torch.Tensor, agg_ht: torch.Tensor, *,
                       subpixel: bool) -> torch.Tensor:
    """Transpose-add of agg_ht (D, W, H) onto agg_v (D, H, W) in float32,
    then :func:`epilogue` -> float32 (H, W)."""
    c = agg_v.to(torch.float32) + agg_ht.transpose(1, 2).to(torch.float32)
    return epilogue(c, subpixel)


def sgm_epilogue(agg_v: torch.Tensor, agg_ht: torch.Tensor, *,
                 subpixel: bool) -> torch.Tensor:
    """``_sgm_epilogue_pallas`` counterpart: the summed volume never
    reaches memory."""
    if _uses_plain(agg_v, agg_ht):
        return sgm_epilogue_plain(agg_v, agg_ht, subpixel=subpixel)
    return _kernels.sgm_epilogue(agg_v, agg_ht, subpixel)


def diagonal_argmin_right(agg: torch.Tensor) -> torch.Tensor:
    """Right-referenced argmin over the diagonal of a left-referenced
    (D, H, W) volume: costR(xr, d) = agg[d, y, xr + d], valid where
    xr + d < W; strict first minimum. Returns (H, W) int32."""
    D, H, W = agg.shape
    bc = torch.full((H, W), INF, dtype=torch.float32, device=agg.device)
    bd = torch.zeros((H, W), dtype=torch.int32, device=agg.device)
    for d in range(min(D, W)):
        cost = agg[d, :, d:].to(torch.float32)
        better = cost < bc[:, :W - d]
        bc[:, :W - d] = torch.where(better, cost, bc[:, :W - d])
        bd[:, :W - d] = torch.where(better, d, bd[:, :W - d])
    return bd


# -- the chain ----------------------------------------------------------------

def _costs(left, right, max_disparity):
    """(cost_t (D, W, H) uint8, cost (D, H, W) bfloat16)."""
    cost_t = census_cost_volume_T(left, right, max_disparity=max_disparity)
    return cost_t, transpose_add(cost_t, out_dtype=torch.bfloat16)


def sgm_disparity(left: torch.Tensor, right: torch.Tensor, *,
                  max_disparity: int, P1: float = 1.0, P2: float = 8.0,
                  subpixel: bool = True,
                  epilogue: str = "unfused") -> torch.Tensor:
    """SGM disparity of a rectified (H, W) uint8 pair -> float32 (H, W),
    subpixel when enabled, the raw integer argmin otherwise.
    ``epilogue``: "unfused" (B4 sums the aggregates, plain-torch argmin /
    parabola; what the server runs) or "fused" (B5). Same results."""
    if epilogue not in ("unfused", "fused"):
        raise ValueError(f"unknown epilogue {epilogue!r}")
    P1, P2 = float(P1), float(P2)
    cost_t, cost = _costs(left, right, max_disparity)
    if epilogue == "unfused":
        agg_dtype = (torch.bfloat16
                     if (_u8_exact(P1, P2) or _bf16_exact(P1, P2))
                     else torch.float32)
        agg_v = aggregate_axis(cost, P1, P2, out_dtype=agg_dtype)
        agg_ht = aggregate_axis(cost_t, P1, P2, out_dtype=agg_dtype)
        del cost, cost_t
        agg = transpose_add(
            agg_ht, agg_v,
            out_dtype=(torch.bfloat16 if _bf16_sum_exact(P1, P2)
                       else torch.float32))
        return _epilogue(agg, subpixel)
    if _u8_exact(P1, P2):
        agg_dtype = torch.uint8
    elif _bf16_exact(P1, P2):
        agg_dtype = torch.bfloat16
    else:
        agg_dtype = torch.float32
    agg_v = aggregate_axis(cost, P1, P2, out_dtype=agg_dtype)
    agg_ht = aggregate_axis(cost_t, P1, P2, out_dtype=agg_dtype)
    return sgm_epilogue(agg_v, agg_ht, subpixel=subpixel)


def sgm_disparity_lr(left: torch.Tensor, right: torch.Tensor, *,
                     max_disparity: int, P1: float = 1.0, P2: float = 8.0,
                     subpixel: bool = True):
    """SGM disparity in both directions from one aggregation: (dispL
    float32 (H, W), dR int32 (H, W) right-referenced integer map)."""
    P1, P2 = float(P1), float(P2)
    cost_t, cost = _costs(left, right, max_disparity)
    agg_dtype = torch.bfloat16 if _bf16_exact(P1, P2) else torch.float32
    agg_v = aggregate_axis(cost, P1, P2, out_dtype=agg_dtype)
    agg_ht = aggregate_axis(cost_t, P1, P2, out_dtype=agg_dtype)
    del cost, cost_t
    agg = transpose_add(
        agg_ht, agg_v,
        out_dtype=(torch.bfloat16 if _bf16_sum_exact(P1, P2)
                   else torch.float32))
    return epilogue(agg, subpixel), diagonal_argmin_right(agg)


def sgm_lr_checked(left: torch.Tensor, right: torch.Tensor, *,
                   max_disparity: int, P1: float = 1.0, P2: float = 8.0,
                   threshold: float = 1.0):
    """SGM disparity with left-right consistency filtering: (disp float32
    with invalid pixels at 0, valid mask)."""
    dL, dR = sgm_disparity_lr(left, right, max_disparity=max_disparity,
                              P1=P1, P2=P2)
    W = left.shape[-1]
    xs = torch.arange(W, device=dL.device)
    idx = (xs - torch.round(dL).to(torch.int64)).clamp(0, W - 1)
    dR_at = dR.gather(-1, idx)
    valid = (dL - dR_at.to(torch.float32)).abs() <= threshold
    return torch.where(valid, dL, 0.0), valid
