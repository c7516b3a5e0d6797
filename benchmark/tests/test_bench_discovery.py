"""A configuration with its own reference, a traffic mix and a per-layer
metric are added as new files and entries only: the harness finds them by
name."""

import json
import os
import shutil
import textwrap
import time

import numpy as np
import torch

from benchmark import judge, run
from benchmark.scene import Scene
from benchmark.tests.tiny import TINY_CONFIG, TINY_TRAFFIC, tiny_checkout


def test_new_files_are_found_by_name(tmp_path):
    spec = tiny_checkout(str(tmp_path))
    bench = tmp_path / "benchmark"
    shutil.copy(bench / "reference" / "sgm_census.py",
                bench / "reference" / "census_again.py")
    with open(bench / "configs" / "tiny_again.json", "w") as f:
        json.dump(dict(TINY_CONFIG, name="tiny_again",
                       reference="benchmark/reference/census_again.py"), f)
    spec["configs"].append({"name": "tiny_again", "source": "test",
                            "file": "benchmark/configs/tiny_again.json",
                            "reduced": [], "why": "test"})
    with open(bench / "traffic" / "slow.json", "w") as f:
        json.dump(dict(TINY_TRAFFIC, name="slow", rate_hz=5), f)
    (bench / "metrics" / "dummy.per_rig.py").write_text(textwrap.dedent("""
        def read(run):
            return run.offered / int(run.traffic["rigs"])
    """))
    spec["workloads"].append({"name": "tiny.slow", "config": "tiny_again",
                              "traffic": "slow", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "dummy.per_rig", "unit": "pairs",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["tiny.slow"]})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(spec, f)
    cell, config, traffic = run.cell_parts(spec, "tiny.slow", str(bench),
                                           str(tmp_path))
    assert traffic["rate_hz"] == 5 and config["name"] == "tiny_again"
    names = [m["name"] for m in run.cell_metrics(spec, "tiny.slow", False)]
    assert "dummy.per_rig" in names
    assert "dummy.per_rig" not in [
        m["name"] for m in run.cell_metrics(spec, "tiny.cam", False)]
    line = run.run_cell(spec, "tiny.slow", 3, 2.0, False, device="cpu",
                        bench_dir=str(bench), root=str(tmp_path),
                        t_start=time.perf_counter())
    assert line["metrics"]["dummy.per_rig"]["value"] == 10
    assert line["correct"], line["checks"]
    assert os.path.exists(bench / "metrics" / "served_fps.py")


def test_the_judge_uses_the_reference_the_configuration_names(tmp_path):
    ref_dir = tmp_path / "benchmark" / "reference"
    ref_dir.mkdir(parents=True)
    (ref_dir / "one_more.py").write_text(textwrap.dedent("""
        import numpy as np

        def depth_u8(pairs, config, device, dtype=None):
            return [np.full(p[0].shape, 1, np.uint8) for p in pairs]

        def colorize(disp_u8):
            return np.repeat(disp_u8[..., None], 3, -1)
    """))
    config = dict(TINY_CONFIG, reference="benchmark/reference/one_more.py")
    reference = judge.load_reference(str(tmp_path), config)
    scene = Scene(height=80, width=640, max_disparity=16,
                  traffic=TINY_TRAFFIC, seed=3, rig=0)
    flat = np.full((80, 640), 1, np.uint8)
    served = [judge.Served(0, 4, flat, np.repeat(flat[..., None], 3, -1)),
              judge.Served(0, 5, flat + 1, None)]
    got = judge.compare(served, [scene], reference, config,
                        torch.device("cpu"))
    assert got["map_px_wrong"] == 80 * 640
    assert (got["depth_px_wrong"], got["maps_wrong"]) == (0, 1)
