"""The control (the reference in bfloat16 in the program's place) comes
out not correct, at a size a test run holds."""

import torch

from benchmark import control
from benchmark.tests.tiny import tiny_checkout


def test_bfloat16_control_is_not_correct(tmp_path):
    spec = tiny_checkout(str(tmp_path))
    for seed in (1, 2**31 + 9, 77):
        got = control.control_readings(
            spec, "tiny.cam", seed, 3.0, torch.device("cpu"),
            bench_dir=str(tmp_path / "benchmark"), root=str(tmp_path))
        assert not got["correct"]
        assert got["checks"]["map_px_wrong"]["value"] > 0
        assert got["checks"]["ids_bad"]["value"] == 0
