"""Model-level API: the SAD block-matching and census/SGM engines."""

from steroscopic_hardware_tpu_torch.models.blockmatch import (
    BlockMatcher,
    SGMMatcher,
)

__all__ = ["BlockMatcher", "SGMMatcher"]
