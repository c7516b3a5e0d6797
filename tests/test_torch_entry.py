"""The port's entry hook (``steroscopic_hardware_tpu_torch/entry.py``)
against the repository's ``__graft_entry__.py`` on the CPU, and the
no-fallback rule of the entry points added beside it:

* ``entry(device="cpu")`` draws the same 480x640 pair from
  ``np.random.default_rng(0)`` as the original, and its ``fn(*args)``
  equals the original's (``disparity_xla`` at block 7 / maxDisparity 64
  on the CPU) bit for bit;
* ``dryrun_multichip(2, device="cpu")`` runs the dry run's cases over two
  gloo ranks and every stage matches one rank;
* ``entry()``, ``dryrun_multichip`` and each new tool with the default
  ``--device cuda`` raise without a GPU.
"""

import numpy as np
import pytest
import torch

import __graft_entry__
from steroscopic_hardware_tpu_torch import entry
from steroscopic_hardware_tpu_torch.tools import (
    bench_scaling,
    run_sweep,
    run_synth_slam,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU ops: one intra-op thread (the suite runs several worker
    processes, and their thread teams would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_equals_the_original_bit_for_bit():
    fn, (left, right) = entry.entry(device="cpu")
    jfn, (jleft, jright) = __graft_entry__.entry()
    assert left.device.type == "cpu" and left.dtype == torch.uint8
    assert np.array_equal(left.numpy(), np.asarray(jleft))
    assert np.array_equal(right.numpy(), np.asarray(jright))
    got = fn(left, right)
    assert got.shape == (480, 640) and got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(jfn(jleft, jright)))


def test_dryrun_multichip_over_two_gloo_ranks():
    stages = entry.dryrun_multichip(2, device="cpu")
    assert set(stages) == {"sad", "sgm", "ba", "pg"}
    assert stages["sad"]["shapes"] == {"disp": [16, 128]}
    assert stages["sad"]["equal"] and stages["sgm"]["equal"]
    assert stages["ba"]["within_tolerance"]
    assert stages["pg"]["within_tolerance"]


@pytest.mark.parametrize("call", [
    lambda: entry.entry(),
    lambda: entry.entry(device="cuda"),
    lambda: entry.dryrun_multichip(1),
    lambda: entry.main([]),
    lambda: run_sweep.main(["--synthetic"]),
    lambda: run_sweep.main(["--synthetic", "--engine", "sgm"]),
    lambda: run_synth_slam.main([]),
    lambda: run_synth_slam.main(["--suite"]),
    lambda: bench_scaling.main([]),
    lambda: bench_scaling.main(["--batch-axis"]),
], ids=["entry", "entry-cuda", "dryrun", "entry-main", "sweep",
        "sweep-sgm", "synth-slam", "suite", "scaling-ranks",
        "scaling-batch"])
def test_cuda_raises_without_a_gpu(call):
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the no-fallback rule needs one "
                    "without")
    with pytest.raises(RuntimeError, match="cuda"):
        call()
