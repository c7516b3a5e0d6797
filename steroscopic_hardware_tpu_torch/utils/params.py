"""Algorithm parameters and validation (reference parity).

Mirrors ``pkg/despair/params.go:21-37`` (the ``Parameters`` struct with
``blockSize``/``maxDisparity`` and atomically-swappable defaults) and the
HTTP layer's validation rules (``cmd/handlers/params.go:37,51``):
block size odd in [3, 31]; max disparity in [16, 256] and a multiple of 16.

Note the reference's own default (BlockSize=16) violates its odd-only rule;
``validate_params`` is applied at the API boundary exactly as the reference
does, while the compute kernels accept any block size >= 1 with Go
``half = B // 2`` semantics.

The port's own copy of ``steroscopic_hardware_tpu/utils/params.py``,
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass(frozen=True)
class Parameters:
    """Stereo block-matching parameters (pkg/despair/params.go:34-37)."""

    block_size: int = 16
    max_disparity: int = 64

    def to_json(self) -> dict:
        return {"blockSize": self.block_size, "maxDisparity": self.max_disparity}


# Compile-bucket envelope: every (block, disparity) combination the HTTP API
# can request, so jit caches can be enumerated/prewarmed.
VALID_BLOCK_SIZES = tuple(range(3, 32, 2))
VALID_MAX_DISPARITIES = tuple(range(16, 257, 16))


class ParamValidationError(ValueError):
    pass


def validate_params(block_size: int, max_disparity: int) -> Parameters:
    """HTTP-boundary validation, same envelope and messages in spirit as
    cmd/handlers/params.go:14-69."""
    if not isinstance(block_size, int) or isinstance(block_size, bool):
        raise ParamValidationError("blockSize must be an integer")
    if not isinstance(max_disparity, int) or isinstance(max_disparity, bool):
        raise ParamValidationError("maxDisparity must be an integer")
    if block_size < 3 or block_size > 31:
        raise ParamValidationError(
            f"blockSize {block_size} out of range [3, 31]"
        )
    if block_size % 2 == 0:
        raise ParamValidationError(f"blockSize {block_size} must be odd")
    if max_disparity < 16 or max_disparity > 256:
        raise ParamValidationError(
            f"maxDisparity {max_disparity} out of range [16, 256]"
        )
    if max_disparity % 16 != 0:
        raise ParamValidationError(
            f"maxDisparity {max_disparity} must be a multiple of 16"
        )
    return Parameters(block_size, max_disparity)


class ParamStore:
    """Thread-safe live-retunable parameter store.

    Equivalent of the reference's atomic global (``pkg/despair/params.go:8-30``):
    the streaming pipeline reads the current value at each frame, so updates
    take effect on the next frame without a pipeline restart
    (``pkg/despair/sad.go:51-53``).
    """

    def __init__(self, initial: Parameters | None = None):
        self._lock = threading.Lock()
        self._params = initial or Parameters()

    def get(self) -> Parameters:
        with self._lock:
            return self._params

    def set(self, params: Parameters) -> None:
        with self._lock:
            self._params = params
