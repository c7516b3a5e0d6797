"""The port's measurement tools against the JAX originals on the CPU:
``steroscopic_hardware_tpu_torch/bench.py`` (root ``bench.py``),
``tools/bench_table.py`` and ``tools/sgm_bench.py``.

* bench: its differenced timer at a small size, and its guard and line
  on the 640x480 ``--synthetic`` pair on ``--device cpu`` with the timer
  stubbed (the line's fields; a failed guard and a non-positive
  difference give the original's error lines; absent files raise);
* the row names of ``bench_table`` and ``sgm_bench`` equal the JAX tools'
  (read by running the JAX tools with their timer stubbed), less the rows
  ``sgm_bench.NOT_PORTED`` lists;
* every SAD row of the table: three chained steps on the same seeded pair
  (24x80, batch rows of F frames) give the port's uint8 chain == the JAX
  step's (the Pallas kernels in interpret mode, as ``tests/test_sad_pallas
  .py`` runs them), exactly;
* every SGM row of the table: for three chained steps the subpixel map of
  the same input equals the JAX package's (the XLA backend, its plain
  reference) within 1e-5, ``tests/test_torch_sgm.py``'s SUBPIXEL_TOL, and
  the uint8 carries are equal.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu.models import slam as jslam
from steroscopic_hardware_tpu.ops import sad_pallas
from steroscopic_hardware_tpu.ops import sgm as jsgm
from steroscopic_hardware_tpu_torch import bench
from steroscopic_hardware_tpu_torch.ops import sgm
from steroscopic_hardware_tpu_torch.tools import bench_table, sgm_bench

ROOT = Path(__file__).resolve().parent.parent
SUBPIXEL_TOL = 1e-5   # tests/test_torch_sgm.py
SIZE = (24, 80)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU ops: one intra-op thread (the suite runs several worker
    processes, and their thread teams would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- bench ------------------------------------------------------------------------

def _stub_timer(monkeypatch, dt=1e-3):
    """diff_time replaced by one step of the chain and a fixed ``dt``; the
    chain lengths it was given land in the returned list."""
    lengths = []

    def diff_time(step, carry, n1, n2):
        assert step(carry).shape == carry.shape
        lengths.append((n1, n2))
        return dt

    monkeypatch.setattr(bench, "diff_time", diff_time)
    return lengths


def test_bench_line_on_cpu(monkeypatch):
    lengths = _stub_timer(monkeypatch)
    left, right = bench.synthetic_pair()
    assert bench.guard(left, right, "cpu") is None
    line = bench.run(left, right, "cpu")
    assert "error" not in line, line
    assert lengths == [(25, 100)]
    assert line["metric"] == "disparity_fps_640x480_b7_d64"
    assert line["unit"] == "fps" and line["value"] == pytest.approx(1e3)
    assert line["vs_baseline"] == line["value"] / 30.0
    d = line["detail"]
    assert d["platform"] == "cpu" and d["card"] == "cpu"
    assert (d["block_size"], d["max_disparity"]) == (7, 64)
    assert d["chain"] == [25, 100]
    assert d["ms_per_frame"] == pytest.approx(1e3 / line["value"])
    assert d["mpix_per_s"] == pytest.approx(480 * 640 / 1e6 * line["value"])


def test_bench_guard_fails_on_a_wrong_golden(monkeypatch):
    from steroscopic_hardware_tpu_torch.ops import sad_golden

    lengths = _stub_timer(monkeypatch)
    monkeypatch.setattr(sad_golden, "disparity_numpy",
                        lambda l, r, b, d: np.zeros(l.shape, np.uint8) + 1)
    left, right = bench.synthetic_pair()
    assert bench.guard(left, right, "cpu") == "bit-exactness check failed"
    line = bench.run(left, right, "cpu")
    assert line == {"metric": bench.METRIC, "value": 0.0, "unit": "fps",
                    "vs_baseline": 0.0,
                    "error": "bit-exactness check failed"}
    assert lengths == []


def test_bench_non_positive_difference(monkeypatch):
    """A clock under which T(n2) == T(n1): diff_time raises, and the bench
    prints the original's error line (the chains' steps an identity, so
    that the full lengths cost nothing here)."""
    clock = iter(range(10**6))
    monkeypatch.setattr(bench.time, "perf_counter", lambda: next(clock))
    real = bench.diff_time
    with pytest.raises(RuntimeError, match="non-positive timing difference"):
        real(lambda x: x, torch.zeros(8, dtype=torch.uint8), 2, 4)
    monkeypatch.setattr(bench, "diff_time", lambda step, carry, n1, n2: real(
        lambda x: x, carry, n1, n2))
    line = bench.run(*bench.synthetic_pair(), "cpu")
    assert line["value"] == 0.0
    assert line["error"].startswith("non-positive timing difference "
                                    "(T(25)=")


def test_diff_time_cancels_the_fixed_cost(monkeypatch):
    """A step of 3 clock ticks after a fixed 7: (T(8) - T(2)) / 6 == 3."""
    now = [0]
    monkeypatch.setattr(bench.time, "perf_counter", lambda: now[0])

    class Carry:
        device = torch.device("cpu")

        def reshape(self, *a):
            return self

        def __getitem__(self, k):
            return self

        def cpu(self):
            now[0] += 7
            return self

    def step(c):
        now[0] += 3
        return c

    assert bench.diff_time(step, Carry(), 2, 8) == 3.0


def test_bench_main_prints_one_line(monkeypatch, capsys):
    _stub_timer(monkeypatch)
    assert bench.main(["--synthetic", "--device", "cpu"]) == 0
    (line,) = capsys.readouterr().out.strip().splitlines()
    assert json.loads(line)["detail"]["platform"] == "cpu"


def test_bench_absent_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="--synthetic"):
        bench.main(["--device", "cpu", "--left", str(tmp_path / "L.png"),
                    "--right", str(tmp_path / "R.png")])


# -- the row names ----------------------------------------------------------------

def test_bench_table_names_equal_the_original(monkeypatch):
    """The JAX tool run with its timer stubbed and its front end faked
    (nothing is computed) lists its rows; the port's are the same."""
    jtool = _load("bench_table")
    monkeypatch.setattr(jtool, "diff_time", lambda *a, **k: 1.0)
    monkeypatch.setattr(jslam, "_frame_frontend", lambda *a, **k: ())
    monkeypatch.setattr(sys, "argv", ["bench_table.py"])
    jtool.main()
    assert [r["name"] for r in jtool.RESULTS] == bench_table.names()
    assert not any("error" in r for r in jtool.RESULTS)


def test_sgm_bench_names_equal_the_original(monkeypatch, capsys):
    """The JAX tool at 32x16 d8 with its timer stubbed prints its rows
    (the Pallas kernels it builds the stage inputs with run in interpret
    mode); the port's are the same, less NOT_PORTED."""
    jtool = _load("sgm_bench")
    monkeypatch.setattr(jtool, "diff_time", lambda *a, **k: 1.0)
    for name in ("_transpose_add_pallas", "_aggregate_axis_pallas",
                 "_sgm_epilogue_pallas"):
        fn = getattr(jsgm, name)
        monkeypatch.setattr(jsgm, name, lambda *a, _f=fn, **k: _f(
            *a, interpret=True, **k))
    monkeypatch.setattr(sys, "argv", ["sgm_bench.py", "--size", "32x16",
                                      "--maxd", "8"])
    jtool.main()
    tail = " 1000.000 ms"
    names = [line[2:-len(tail)].rstrip()
             for line in capsys.readouterr().out.splitlines()
             if line.endswith(tail)]
    assert len(names) == 31
    assert set(sgm_bench.NOT_PORTED) <= set(names)
    assert [n for n in names if n not in sgm_bench.NOT_PORTED] == \
        sgm_bench.names()


# -- the rows' steps against the JAX steps ----------------------------------------

def _recording_pair(seed=5):
    """A pair function of the table that ignores the row's size (SIZE),
    recording the numpy pairs it hands out."""
    pair = bench_table.seeded_pairs("cpu", seed)
    made = []

    def small(h, w):
        L, R = pair(*SIZE)
        made.append((L.numpy(), R.numpy()))
        return L, R
    return small, made


def _jax_sad_step(name, made):
    kw = dict(interpret=True)
    if "batch" in name:
        Rs = np.stack([r for _, r in made[len(made) // 2:]])
        return lambda x: sad_pallas.disparity_pallas_batch(
            x, Rs, block_size=7, max_disparity=64, **kw)
    R = made[0][1]
    if "LEFT+RIGHT" in name:
        return lambda x: (sad_pallas.disparity_pallas_lr(
            x, R, block_size=7, max_disparity=64, **kw)[0] * 255
            // 64).astype(jnp.uint8)
    if "SUBPIXEL" in name:
        return lambda x: jnp.clip(sad_pallas.disparity_pallas_subpixel(
            x, R, block_size=7, max_disparity=64, **kw)[0] * 4.0, 0,
            255).astype(jnp.uint8)
    b, d = (int(t[1:]) for t in name.split()[1:3])
    return lambda x: sad_pallas.disparity_pallas(
        x, R, block_size=b, max_disparity=d, **kw)


SAD_ROWS = [n for n in bench_table.names()
            if "SGM" not in n and "SLAM" not in n]
SGM_ROWS = [n for n in bench_table.names()
            if "SGM" in n and "SLAM" not in n]


def test_rows_are_split_as_the_original():
    assert len(SAD_ROWS) == 11 and len(SGM_ROWS) == 7
    assert len(bench_table.names()) == 25


@pytest.mark.parametrize("name", SAD_ROWS)
def test_sad_row_chain_equals_jax(name):
    make = dict((n, m) for n, _, m, _ in bench_table.specs())[name]
    pair, made = _recording_pair()
    step, x, _, _ = make(pair)
    jstep = _jax_sad_step(name, made)
    for _ in range(3):
        want = np.asarray(jstep(x.numpy()))
        x = step(x)
        assert x.dtype == torch.uint8
        assert np.array_equal(x.numpy(), want), name


@pytest.mark.parametrize("name", SGM_ROWS)
def test_sgm_row_chain_equals_jax(name, monkeypatch):
    """Each step's subpixel map against the JAX package's on the same
    input (the map is read where the port's step makes it)."""
    make = dict((n, m) for n, _, m, _ in bench_table.specs())[name]
    pair, made = _recording_pair()
    d = int(name.split()[2][1:])
    lr = "fused LR" in name
    maps = []
    fn = sgm.sgm_disparity_lr if lr else sgm.sgm_disparity
    monkeypatch.setattr(sgm, fn.__name__, lambda *a, **k: maps.append(
        fn(*a, **k)) or maps[-1])
    step, x, _, _ = make(pair)
    R = made[0][1]
    for _ in range(3):
        if lr:
            want = jsgm.sgm_disparity_lr(x.numpy(), R, max_disparity=d,
                                         subpixel=True, backend="xla")[0]
        else:
            want = jsgm.sgm_disparity(x.numpy(), R, max_disparity=d,
                                      subpixel=True, backend="xla")
        x = step(x)
        got = maps[-1][0] if lr else maps[-1]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=SUBPIXEL_TOL)
        assert np.array_equal(x.numpy(), np.clip(
            np.asarray(want) * 4.0, 0, 255).astype(np.uint8)), name
