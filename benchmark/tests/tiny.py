"""A tiny cell for the CPU tests: the harness's files copied into a
temporary checkout with one small configuration and traffic mix."""

from __future__ import annotations

import json
import os
import shutil

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

TINY_CONFIG = {
    "name": "tiny_sgm16", "height": 80, "width": 640,
    "server_args": ["--backend", "sgm"],
    "params": {"block_size": 16, "max_disparity": 16},
    "p1": 1.0, "p2": 8.0, "subpixel": True,
    "reference": "benchmark/reference/sgm_census.py",
}
TINY_TRAFFIC = {"name": "tiny", "rate_hz": 12, "rigs": 1,
                "pan_px_per_frame": 2, "pan_frames": 30, "planes": 4,
                "id_tile_px": 16}


def tiny_checkout(tmp, rigs: int = 1, traffic: dict | None = None) -> dict:
    """A checkout under ``tmp`` holding a copy of ``benchmark/`` and a
    BENCHMARK.json whose cells are the real ones plus ``tiny.cam``; returns
    the spec."""
    bench = os.path.join(tmp, "benchmark")
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(bench, "configs", "tiny_sgm16.json"), "w") as f:
        json.dump(TINY_CONFIG, f)
    mix = dict(traffic or TINY_TRAFFIC, rigs=rigs)
    with open(os.path.join(bench, "traffic", "tiny.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny_sgm16",
                            "source": "benchmark/tests/tiny.py",
                            "file": "benchmark/configs/tiny_sgm16.json",
                            "reduced": [], "why": "CPU tests"})
    spec["workloads"].append({"name": "tiny.cam", "config": "tiny_sgm16",
                              "traffic": "tiny", "chips": 1,
                              "why": "CPU tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.cam")
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return spec
