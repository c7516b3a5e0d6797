"""Row-band SAD disparity over the ranks of a mesh axis, with a halo
exchange (counterpart of
``steroscopic_hardware_tpu/parallel/disparity_shard.py``).

Each rank owns a contiguous band of rows and receives ``h = block_size //
2`` boundary rows from each neighbour on the ``rows`` axis (JAX's
``ppermute``; here one ``all_to_all`` in which a rank sends its first h
rows to the previous rank and its last h rows to the next). The ends get
zeros, which is the reference's zero-contribution row clamp, so B1 (the
``sad_wta`` kernel, ``ops/sad.py::disparity``) run once on the extended
band gives, on the band's own rows, the single-process map bit for bit.
The sweep is horizontal, so no column halo is needed.

The JAX function checks only that the axis size divides H. When the halo
is taller than a band it sends the whole band, the concatenated band comes
out short and the crop is misaligned: a wrong map without an error. Here
that case raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from steroscopic_hardware_tpu_torch.ops.sad import disparity
from steroscopic_hardware_tpu_torch.parallel.multihost import all_to_all


def _halo_exchange(x: torch.Tensor, h: int, group) -> torch.Tensor:
    """x with the last h rows of the previous rank's band above it and the
    first h rows of the next rank's below it (zeros at the ends)."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    top = x.new_zeros((h, *x.shape[1:]))
    bottom = top
    if h and n > 1:
        rows = [0] * n
        parts = []
        if i > 0:
            rows[i - 1] = h
            parts.append(x[:h])
        if i < n - 1:
            rows[i + 1] = h
            parts.append(x[-h:])
        got = all_to_all(torch.cat(parts), group, rows, rows, tag="halo")
        if i > 0:
            top = got[:h]
        if i < n - 1:
            bottom = got[-h:]
    return torch.cat([top, x, bottom])


def disparity_sharded(left_band: torch.Tensor, right_band: torch.Tensor, *,
                      block_size: int, max_disparity: int, mesh,
                      axis_name: str = "rows") -> torch.Tensor:
    """uint8 disparity of this rank's row band of an (H, W) pair, bit for
    bit the rows of the single-process map: the bands are this rank's
    blocks of H / n rows (``multihost.shard``, which raises unless n
    divides H), the result this rank's block of the map
    (``multihost.all_gather`` joins them). Raises ValueError when the halo
    (block_size // 2 rows) is taller than a band. The bands' device picks
    the kernel or its plain version, as ``ops.sad.disparity``."""
    group = mesh.get_group(axis_name)
    h = block_size // 2
    rows, W = left_band.shape
    if h > rows:
        raise ValueError(
            f"the halo of block {block_size} ({h} rows) is taller than a "
            f"band of {rows} rows on mesh axis {axis_name}: use fewer ranks "
            "or a smaller block")
    # both images' halos in one exchange
    ext = _halo_exchange(torch.cat([left_band, right_band], 1), h, group)
    out = disparity(ext[:, :W].contiguous(), ext[:, W:].contiguous(),
                    block_size=block_size, max_disparity=max_disparity)
    return out[h:h + rows]
