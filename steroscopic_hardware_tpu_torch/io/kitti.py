"""KITTI odometry dataset loader (stereo sequences, calib, poses); a copy
of ``steroscopic_hardware_tpu/io/kitti.py`` on the port's ``ops.gray`` and
``StereoCamera``.

BASELINE config #4 names KITTI odometry as the VO accuracy benchmark; this
loader reads the standard layout so the engine runs on it directly when a
dataset is mounted:

  sequences/NN/image_0/XXXXXX.png   left gray
  sequences/NN/image_1/XXXXXX.png   right gray
  sequences/NN/calib.txt            P0..P3 3x4 projection matrices
  poses/NN.txt                      ground-truth 3x4 poses (cam0->world)

No dataset ships in this environment (zero egress); the format is
validated against synthetic files in tests.
"""

from __future__ import annotations

import os

import numpy as np

from steroscopic_hardware_tpu_torch.ops.gray import load_gray


def read_calib(path: str) -> dict:
    """Parse calib.txt -> {name: (3, 4) float64}."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            name, vals = line.split(":", 1)
            arr = np.array([float(v) for v in vals.split()])
            if arr.size == 12:
                out[name.strip()] = arr.reshape(3, 4)
    return out


def read_poses(path: str) -> np.ndarray:
    """Parse a poses file -> (N, 4, 4) cam0->world transforms."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    n = rows.shape[0]
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :] = rows
    return out


class KittiOdometry:
    """One odometry sequence: stereo frames + intrinsics + GT poses."""

    def __init__(self, root: str, sequence: str):
        self.seq_dir = os.path.join(root, "sequences", sequence)
        self.left_dir = os.path.join(self.seq_dir, "image_0")
        self.right_dir = os.path.join(self.seq_dir, "image_1")
        calib = read_calib(os.path.join(self.seq_dir, "calib.txt"))
        P0, P1 = calib["P0"], calib["P1"]
        self.fx = float(P0[0, 0])
        self.fy = float(P0[1, 1])
        self.cx = float(P0[0, 2])
        self.cy = float(P0[1, 2])
        # baseline from the right camera's horizontal offset: P1[0,3] = -fx*b
        self.baseline = float(-P1[0, 3] / P1[0, 0])
        self.frames = sorted(
            f for f in os.listdir(self.left_dir) if f.endswith(".png")
        )
        poses_path = os.path.join(root, "poses", sequence + ".txt")
        self.poses = (
            read_poses(poses_path) if os.path.exists(poses_path) else None
        )

    def __len__(self):
        return len(self.frames)

    def stereo_camera(self):
        from steroscopic_hardware_tpu_torch.models.slam import StereoCamera

        return StereoCamera(
            fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy,
            baseline=self.baseline,
        )

    def pair(self, i: int):
        name = self.frames[i]
        return (
            load_gray(os.path.join(self.left_dir, name)),
            load_gray(os.path.join(self.right_dir, name)),
        )

    def gt_positions(self) -> np.ndarray | None:
        if self.poses is None:
            return None
        return self.poses[:, :3, 3]
