"""The command: no result without the card the cell asks for; on the card
(``-m gpu``) a short run of each cell prints a complete line."""

import json
import subprocess
import sys

import pytest

from benchmark import run

CELLS = tuple(w["name"] for w in run.load_json(
    f"{run.ROOT}/BENCHMARK.json")["workloads"])


def command(cell, trace, seconds=3):
    return [sys.executable, "-m", "benchmark.run", "--workload", cell,
            "--seed", str(2**31 + 17), "--seconds", str(seconds),
            "--trace", str(trace)]


def test_no_card_no_result(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    out = subprocess.run(command(CELLS[0], 0), cwd=run.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


def test_unknown_workload_no_result():
    out = subprocess.run(command("no.such.cell", 0), cwd=run.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(cuda, cell, trace):
    out = subprocess.run(command(cell, trace, seconds=4), cwd=run.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    device = line["device"]
    assert device["platform"] == "gpu" and device["count"] == 1
    if trace:
        assert 0 < device["busy_s"] <= device["window_s"]
