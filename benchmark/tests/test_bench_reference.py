"""The plain reference against the program's CPU path, and its control."""

import numpy as np
import pytest
import torch

from benchmark.reference import sgm_census
from benchmark.scene import Scene
from steroscopic_hardware_tpu_torch.models.blockmatch import sgm_one
from steroscopic_hardware_tpu_torch.ops.colorize import colorize_disparity_lut

TRAFFIC = {"id_tile_px": 16, "pan_px_per_frame": 3, "pan_frames": 20,
           "planes": 5}
CPU = torch.device("cpu")


@pytest.mark.parametrize("maxd,frame_id", [(16, 3), (32, 41)])
def test_reference_matches_the_ports_cpu_path(maxd, frame_id):
    sc = Scene(height=80, width=640, max_disparity=maxd, traffic=TRAFFIC,
               seed=20261018, rig=1)
    left, right = sc.pair(frame_id)
    program = sgm_one(torch.from_numpy(left), torch.from_numpy(right),
                      max_disparity=maxd, p1=1.0, p2=8.0, subpixel=True,
                      lr=False, threshold=1.0).numpy()
    config = {"params": {"max_disparity": maxd}, "p1": 1.0, "p2": 8.0,
              "subpixel": True}
    [ref] = sgm_census.depth_u8([(left, right)], config, CPU)
    assert np.array_equal(program, ref)
    assert np.array_equal(colorize_disparity_lut(program),
                          sgm_census.colorize(ref))


def test_pairs_in_one_block_match_pairs_alone():
    sc = Scene(height=80, width=640, max_disparity=16, traffic=TRAFFIC,
               seed=5, rig=0)
    config = {"params": {"max_disparity": 16}, "p1": 1.0, "p2": 8.0,
              "subpixel": True}
    pairs = [sc.pair(k) for k in (0, 7, 8)]
    together = sgm_census.depth_u8(pairs, config, CPU)
    alone = [sgm_census.depth_u8([p], config, CPU)[0] for p in pairs]
    assert all(np.array_equal(a, b) for a, b in zip(together, alone))


def test_reference_without_subpixel_is_the_first_minimum():
    rng = np.random.default_rng(0)
    total = torch.from_numpy(rng.integers(0, 4, (9, 5, 7)).astype(
        np.float32))
    disp = sgm_census.disparity(total[None], subpixel=False)[0]
    first = np.argmax(total.numpy() == total.numpy().min(0), axis=0)
    assert np.array_equal(disp.numpy(), first)
