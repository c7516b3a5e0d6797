"""Reference-parity convenience API (``pkg/despair`` equivalent), the
counterpart of ``steroscopic_hardware_tpu/despair.py``.

One-call functions with the same roles as the reference package's public
surface, for users migrating from the Go engine:

  Go (pkg/despair)                      here
  ---------------------------------     ----------------------------------
  RunSad(left, right, B, D)             run_sad(left, right, B, D)
  SumAbsoluteDifferences(...)           sum_absolute_differences(...)
  LoadPNG / MustLoadPNG                 load_png(path)
  SavePNG / MustSavePNG                 save_png(path, img)
  Parameters{BlockSize,MaxDisparity}    utils.params.Parameters
  SetDefaultParams / DefaultParams      set_default_params / default_params

All disparity results are bit-exact with the reference per-pixel algorithm
(see ``ops/sad_golden.py`` for the contract).
"""

from __future__ import annotations

import numpy as np

from steroscopic_hardware_tpu_torch.io.png import read_png, write_png
from steroscopic_hardware_tpu_torch.ops.gray import to_grayscale
from steroscopic_hardware_tpu_torch.ops.sad_golden import sad_window_golden
from steroscopic_hardware_tpu_torch.utils.params import ParamStore, Parameters

_default_store = ParamStore()


def set_default_params(params: Parameters) -> None:
    """pkg/despair/params.go:21-25 equivalent."""
    _default_store.set(params)


def default_params() -> Parameters:
    """pkg/despair/params.go:27-30 equivalent."""
    return _default_store.get()


def run_sad(left, right, block_size: int | None = None,
            max_disparity: int | None = None, *,
            device="cuda") -> np.ndarray:
    """Full-frame uint8 disparity (RunSad, pkg/despair/sad.go:119-169)
    through a ``BlockMatcher`` on ``device``: "cuda" launches the SAD
    kernel (and raises without a usable GPU), "cpu" runs the plain torch
    version."""
    from steroscopic_hardware_tpu_torch.models.blockmatch import BlockMatcher

    p = _default_store.get()
    b = block_size if block_size is not None else p.block_size
    d = max_disparity if max_disparity is not None else p.max_disparity
    m = BlockMatcher(params=Parameters(b, d), device=device)
    return m.compute(np.asarray(left), np.asarray(right))


def sum_absolute_differences(left, right, lx, ly, rx, ry,
                             block_size) -> int:
    """Single-window SAD with the exact reference border clipping
    (SumAbsoluteDifferences, pkg/despair/sad.go:205-244)."""
    return sad_window_golden(
        np.asarray(left), np.asarray(right), lx, ly, rx, ry, block_size
    )


def load_png(path) -> np.ndarray:
    """Decode + exact grayscale conversion (LoadPNG,
    pkg/despair/png.go:10-38)."""
    return to_grayscale(read_png(path))


def save_png(path, img) -> None:
    """Encode grayscale/color PNG (SavePNG, pkg/despair/png.go:55-66)."""
    write_png(path, np.asarray(img))
