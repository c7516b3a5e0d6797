"""Stereo calibration files for the live serving path (a copy of
``steroscopic_hardware_tpu/io/calib.py``, whose package import loads jax).

The reference assumes a fixed pre-rectified rig (frames go straight from
the sensors to matching, ``pkg/camera/serial.go:301-323``); arbitrary
cameras need a calibration. This module defines a small JSON format and
builds a :class:`~steroscopic_hardware_tpu_torch.ops.rectify.StereoRectifier`
from it on a given device, so ``python -m steroscopic_hardware_tpu_torch
--calib rig.json`` can serve raw (unrectified, distorted) cameras directly.

Format (JSON object):

.. code-block:: json

    {
      "size": [480, 640],                  // output H, W
      "K1": [[fx,0,cx],[0,fy,cy],[0,0,1]], // left intrinsics
      "K2": [[...]],                       // right intrinsics
      "dist1": [k1, k2, p1, p2, k3],       // optional (null/absent = none)
      "dist2": [k1, k2, p1, p2, k3],
      "R": [[...3x3...]],                  // x_right = R @ x_left + T
      "T": [tx, ty, tz]                    // meters
    }
"""

from __future__ import annotations

import json

import numpy as np

from steroscopic_hardware_tpu_torch.ops.rectify import StereoRectifier


def _mat(obj, name, shape):
    arr = np.asarray(obj[name], np.float64)
    if arr.shape != shape:
        raise ValueError(f"calibration field {name!r} must have shape "
                         f"{shape}, got {arr.shape}")
    return arr


def load_calibration(path: str, device="cuda") -> StereoRectifier:
    """Parse a calibration JSON file into a ready StereoRectifier whose
    maps live on ``device``."""
    with open(path) as f:
        obj = json.load(f)
    return parse_calibration(obj, device=device)


def parse_calibration(obj: dict, device="cuda") -> StereoRectifier:
    K1 = _mat(obj, "K1", (3, 3))
    K2 = _mat(obj, "K2", (3, 3))
    R = _mat(obj, "R", (3, 3))
    T = _mat(obj, "T", (3,))
    size = obj["size"]
    if len(size) != 2 or any(int(s) <= 0 for s in size):
        raise ValueError(f"calibration 'size' must be [H, W], got {size}")
    size = (int(size[0]), int(size[1]))

    def dist(name):
        d = obj.get(name)
        if d is None:
            return None
        d = np.asarray(d, np.float64)
        if d.shape != (5,):
            raise ValueError(f"calibration field {name!r} must be "
                             f"[k1, k2, p1, p2, k3], got shape {d.shape}")
        return tuple(d)

    return StereoRectifier(K1, dist("dist1"), K2, dist("dist2"),
                           R, T, size, device=device)


def save_calibration(path: str, *, K1, K2, R, T, size,
                     dist1=None, dist2=None) -> None:
    """Write a calibration file in the format ``load_calibration`` reads."""
    obj = {
        "size": [int(size[0]), int(size[1])],
        "K1": np.asarray(K1, np.float64).tolist(),
        "K2": np.asarray(K2, np.float64).tolist(),
        "R": np.asarray(R, np.float64).tolist(),
        "T": np.asarray(T, np.float64).tolist(),
        "dist1": None if dist1 is None
        else np.asarray(dist1, np.float64).tolist(),
        "dist2": None if dist2 is None
        else np.asarray(dist2, np.float64).tolist(),
    }
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
