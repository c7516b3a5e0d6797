"""Left-right consistency check (counterpart of ``ops/lr_check.py``).

  dL(x) = disparity of left pixel x (right match at x - dL)
  dR(x) = disparity of right pixel x (left match at x + dR)
  valid iff |dL(x) - dR(x - dL(x))| <= threshold

Invalid pixels carry ``invalid_value`` (255) in the normalized uint8 map and
False in the mask. Plain torch: a gather along W.
"""

from __future__ import annotations

import torch

from steroscopic_hardware_tpu_torch.ops.sad import disparity_lr, normalize


def check_from_raw(dL, dR, W, max_disparity, *, threshold=1,
                   invalid_value=255):
    """LR consistency from raw int32 maps (..., H, W): returns
    ``(disparity_u8, valid_mask)``."""
    xs = torch.arange(dL.shape[-1], device=dL.device)
    idx = (xs - dL).clamp(0, W - 1).to(torch.int64)
    dR_at = torch.gather(dR, -1, idx)
    valid = (dL - dR_at).abs() <= threshold
    disp = normalize(dL, max_disparity)
    # a Python scalar: no host-to-device copy of a one-element tensor
    disp = torch.where(valid, disp, invalid_value)
    return disp, valid


def disparity_lr_checked(left, right, *, block_size: int,
                         max_disparity: int, threshold: int = 1,
                         invalid_value: int = 255):
    """Disparity with left-right consistency filtering, both directions
    from one sweep (the SAD kernel on a CUDA tensor, the plain version on
    a CPU one). Returns ``(disparity_u8, valid_mask)``."""
    dL, dR = disparity_lr(left, right, block_size=block_size,
                          max_disparity=max_disparity)
    return check_from_raw(dL, dR, left.shape[-1], max_disparity,
                          threshold=threshold, invalid_value=invalid_value)
