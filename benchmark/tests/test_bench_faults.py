"""A run on the CPU, without the look for a chip, with the timed path
broken underneath: each fault a served cell can have comes out not
correct, and the sound path comes out correct (``benchmark/faults.py``)."""

import time

import pytest

from benchmark import faults, run
from benchmark.tests.tiny import TINY_TRAFFIC, tiny_checkout
from steroscopic_hardware_tpu_torch.models import blockmatch


def tiny_run(tmp_path, seed, rate_hz=None):
    traffic = None if rate_hz is None else dict(TINY_TRAFFIC, rate_hz=rate_hz)
    spec = tiny_checkout(str(tmp_path), traffic=traffic)
    return run.run_cell(spec, "tiny.cam", seed, 3.0, False, device="cpu",
                        bench_dir=str(tmp_path / "benchmark"),
                        root=str(tmp_path), t_start=time.perf_counter())


def test_sound_path_is_correct(tmp_path):
    line = tiny_run(tmp_path, 2**31 + 11)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0
    assert line["run"]["maps_compared"] >= 2


# rates at which the CPU forms batches of one size, as the card does at
# 1080p: of one pair (state_unchanged), of eight (half_batch_left_out)
@pytest.mark.parametrize("fault,caught_by,rate_hz", [
    ("state_unchanged", "maps_repeated", 3),
    ("half_batch_left_out", None, 30),
    ("answer_altered", "map_px_wrong", None),
    ("no_answer", "sample_empty", None),
])
def test_fault_is_not_correct(tmp_path, fault, caught_by, rate_hz):
    with faults.planted(fault):
        line = tiny_run(tmp_path, 4242, rate_hz)
    assert blockmatch.sgm_serve_step is faults._sound()
    assert not line["correct"], line["checks"]
    failing = [k for k, c in line["checks"].items()
               if c["value"] > c["limit"]]
    if caught_by is not None:
        assert caught_by in failing, line["checks"]
