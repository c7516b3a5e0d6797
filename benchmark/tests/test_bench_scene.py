"""The traffic: id bands decode, scenes follow the seed."""

import numpy as np
import pytest
import torch

from benchmark.reference import sgm_census
from benchmark.scene import IdBand, Scene

TRAFFIC = {"id_tile_px": 16, "pan_px_per_frame": 3, "pan_frames": 20,
           "planes": 5}
CONFIG = {"params": {"max_disparity": 16}, "p1": 1.0, "p2": 8.0,
          "subpixel": True}
CPU = torch.device("cpu")


def scene(seed=2**31 + 3, rig=0, maxd=16):
    return Scene(height=80, width=640, max_disparity=maxd, traffic=TRAFFIC,
                 seed=seed, rig=rig)


@pytest.mark.parametrize("frame_id", [0, 1, 0x5A5A, 0xFFFF, 70000])
def test_id_band_decodes_from_the_matched_map(frame_id):
    sc = scene()
    [disp] = sgm_census.depth_u8([sc.pair(frame_id)], CONFIG, CPU)
    assert sc.band.decode(disp) == frame_id & 0xFFFF


@pytest.mark.parametrize("frame_id", [0, 1, 0x5A5A, 0xFFFE])
def test_a_torn_pair_reads_no_id(frame_id):
    sc = scene()
    left = sc.pair(frame_id)[0]
    right = sc.pair(frame_id + 1)[1]
    [disp] = sgm_census.depth_u8([(left, right)], CONFIG, CPU)
    assert sc.band.decode(disp) is None


def test_id_band_refuses_what_is_not_an_id():
    band = IdBand(80, 640, 16, 16)
    assert band.decode(np.zeros((80, 640), np.uint8)) is None
    assert band.decode(np.full((80, 640), 255, np.uint8)) is None


def test_id_band_must_fit():
    with pytest.raises(ValueError):
        IdBand(80, 500, 16, 16)


def test_scenes_follow_the_seed_and_the_rig():
    a, b = scene().pair(7), scene().pair(7)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    other = scene(seed=-5).pair(7)
    assert not np.array_equal(a[0], other[0])
    assert not np.array_equal(a[0], scene(rig=1).pair(7)[0])


def test_every_pair_differs_from_the_one_before():
    sc = scene()
    prev = sc.pair(0)
    for k in range(1, 45):
        cur = sc.pair(k)
        assert not np.array_equal(cur[0], prev[0])
        assert not np.array_equal(cur[1][sc.band.rows:],
                                  prev[1][sc.band.rows:])
        prev = cur
