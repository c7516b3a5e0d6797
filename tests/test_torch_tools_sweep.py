"""Parity of the port's parameter sweep (``tools/run_sweep.py``) with the
JAX package on the CPU, at 24x64 on the tool's own synthetic pair (its
three shift bands cut to size):

* every SAD map of blocks {3, 7} x maxDisparity {16, 32}, with and without
  ``--lr-check``, equals the JAX ``models.blockmatch.sweep`` output byte
  for byte (XLA on the CPU), in the same grid order; with the check the
  checked map, its mask and ``lr_valid_frac`` equal the JAX
  ``disparity_lr_checked`` result exactly;
* the SGM engine at maxDisparity 16 and 32 equals the JAX
  ``SGMMatcher.compute`` byte for byte (one row per disparity, block 0);
* ``--json`` lines carry the original's keys plus ``kernel_ms``, which is
  null on the CPU (no device clock).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu.models import blockmatch as jbm
from steroscopic_hardware_tpu.ops.lr_check import disparity_lr_checked
from steroscopic_hardware_tpu.utils.params import Parameters as JParameters
from steroscopic_hardware_tpu_torch.tools import run_sweep

SIZE = (24, 64)
BLOCKS, DISPS = (3, 7), (16, 32)
ORIGINAL_KEYS = {"pair", "engine", "block", "disp", "ms", "mpix_s",
                 "compile_s"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU ops: one intra-op thread (the suite runs several worker
    processes, and their thread teams would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    left, right, _ = run_sweep.synthetic_pair(3, SIZE)
    return left, right


@pytest.fixture(scope="module")
def jax_sweep(pair):
    """{(block, disp): map} of the JAX sweep over the grid, and its order."""
    got = list(jbm.sweep(*pair, block_sizes=BLOCKS, max_disparities=DISPS))
    return ({(p.block_size, p.max_disparity): np.asarray(m)
             for p, m in got},
            [(p.block_size, p.max_disparity) for p, m in got])


@pytest.mark.parametrize("lr_check", [False, True])
def test_sad_sweep_equals_jax(pair, jax_sweep, lr_check):
    maps, order = jax_sweep
    rows = list(run_sweep.sweep({"p": pair}, blocks=BLOCKS, disps=DISPS,
                                n=1, lr_check=lr_check, device="cpu"))
    assert [(r["block"], r["disp"]) for r, _, _ in rows] == order
    for rec, out, checked in rows:
        b, d = rec["block"], rec["disp"]
        assert out.dtype == np.uint8
        assert np.array_equal(out, maps[(b, d)]), (b, d)
        if not lr_check:
            assert checked is None and "lr_valid_frac" not in rec
            continue
        jd, jv = disparity_lr_checked(jnp.asarray(pair[0]),
                                      jnp.asarray(pair[1]), block_size=b,
                                      max_disparity=d)
        jv = np.asarray(jv)
        assert np.array_equal(checked[0], np.asarray(jd)), (b, d)
        assert np.array_equal(checked[1], jv), (b, d)
        assert rec["lr_valid_frac"] == float(jv.mean())
        assert 0.0 < rec["lr_valid_frac"] < 1.0


@pytest.mark.parametrize("disp", DISPS)
def test_sgm_sweep_equals_jax(pair, disp):
    rows = list(run_sweep.sweep({"p": pair}, engine="sgm", blocks=BLOCKS,
                                disps=[disp], n=1, device="cpu"))
    assert len(rows) == 1
    rec, out, _ = rows[0]
    assert (rec["engine"], rec["block"], rec["disp"]) == ("sgm", 0, disp)
    m = jbm.SGMMatcher()
    m.set_params(JParameters(7, disp))
    assert np.array_equal(out, m.compute(*pair))


@pytest.mark.parametrize("flags,keys", [
    ([], ORIGINAL_KEYS),
    (["--lr-check"], ORIGINAL_KEYS | {"lr_valid_frac"}),
    (["--engine", "sgm", "--lr-check"], ORIGINAL_KEYS | {"lr_valid_frac"}),
])
def test_json_lines_carry_the_original_keys(monkeypatch, capsys, flags,
                                            keys):
    monkeypatch.setattr(run_sweep, "SYNTHETIC_SIZE", SIZE)
    assert run_sweep.main(["--synthetic", "--device", "cpu", "--json",
                           "--blocks", "5", "--disps", "16,32", "-n", "1",
                           *flags]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [r["disp"] for r in lines] == [16, 32]
    for rec in lines:
        assert set(rec) == keys | {"kernel_ms"}
        assert rec["kernel_ms"] is None
        assert rec["pair"] == "synthetic"
        assert rec["ms"] > 0 and rec["mpix_s"] > 0 and rec["compile_s"] > 0


def test_synthetic_pair_carries_its_shift_field():
    """At the bands' interior the SAD map recovers the known shifts."""
    left, right, truth = run_sweep.synthetic_pair(0, (96, 160))
    assert set(np.unique(truth)) == set(run_sweep.SYNTHETIC_SHIFTS)
    (rec, out, _), = run_sweep.sweep({"p": (left, right)}, blocks=[7],
                                     disps=[48], n=1, device="cpu")
    inner = np.zeros_like(truth, bool)
    for y0 in (0, 32, 64):
        inner[y0 + 4:y0 + 28, 56:156] = True
    want = (truth * 255 // 48).astype(np.uint8)
    assert (out == want)[inner].mean() > 0.95
