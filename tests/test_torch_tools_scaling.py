"""The port's scaling tool (``tools/bench_scaling.py``) on the CPU at
32x64 (block 7, maxDisparity 16):

* ``--batch-axis`` at F = 1 and 2: each launch's output is the next
  launch's left input, and the chain's first and last outputs equal the
  same chain through the plain torch version and through the JAX
  package's ``disparity_xla`` (the XLA path of the original's kernel),
  byte for byte;
* the rank mode over 1 and 2 gloo ranks (one spawned process a rank)
  gathers the one-process map, and the JAX one, byte for byte;
* the printed lines carry the device and the number of cards.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu.ops.sad_xla import disparity_xla
from steroscopic_hardware_tpu_torch.ops.sad import disparity_plain
from steroscopic_hardware_tpu_torch.tools import bench_scaling

H, W, BLOCK, DISP, N = 32, 64, 7, 16, 3
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU ops: one intra-op thread (the suite runs several worker
    processes, and their thread teams would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(*flags):
    return bench_scaling.parse_args(
        ["--device", "cpu", "--height", str(H), "--width", str(W),
         "--block", str(BLOCK), "--disp", str(DISP), "-n", str(N), *flags])


def test_batch_axis_chain_equals_plain_and_jax():
    rows = bench_scaling.bench_batch_axis(_args("--batch-axis"), CPU)
    for F, row in zip((1, 2), rows):
        assert row["batch"] == F
        lefts, rights = row["lefts"], row["rights"]
        assert lefts.shape == (F, H, W)
        x = lefts
        jx = jnp.asarray(lefts.numpy())
        for i in range(N):
            x = disparity_plain(x, rights, block_size=BLOCK,
                                max_disparity=DISP)
            jx = disparity_xla(jx, jnp.asarray(rights.numpy()),
                               block_size=BLOCK, max_disparity=DISP)
            if i == 0:
                assert torch.equal(row["first"], x)
                assert np.array_equal(row["first"].numpy(), np.asarray(jx))
        assert torch.equal(row["last"], x)
        assert np.array_equal(row["last"].numpy(), np.asarray(jx))
        assert row["ms_frame"] > 0 and row["fps"] > 0
        line = bench_scaling.batch_line(row, CPU)
        assert line.startswith(f"batch={F} ") and "[cpu, 0 cards]" in line
    rows.close()


def test_rank_mode_gathers_the_one_process_map():
    rows = list(bench_scaling.bench_ranks(_args(), CPU, sizes=[1, 2]))
    assert [r["ranks"] for r in rows] == [1, 2]
    left, right = rows[0]["left"], rows[0]["right"]
    want = disparity_plain(torch.from_numpy(left), torch.from_numpy(right),
                           block_size=BLOCK, max_disparity=DISP).numpy()
    assert np.array_equal(want, np.asarray(disparity_xla(
        jnp.asarray(left), jnp.asarray(right), block_size=BLOCK,
        max_disparity=DISP)))
    for row in rows:
        assert row["backend"] == "gloo"
        assert np.array_equal(row["disp"], want), row["ranks"]
        assert row["ms_frame"] > 0
        # on the CPU the wrappers run the plain versions: no launches
        assert len(row["launches"]) == row["ranks"]
        assert all(sum(n.values()) == 0 for n in row["launches"])
        assert "[cpu, 0 cards]" in bench_scaling.rank_line(row, CPU)
    assert rows[0]["efficiency_pct"] == 100.0


def test_rank_sizes_divide_the_height():
    sizes = bench_scaling.rank_sizes(CPU, 480)
    assert sizes[0] == 1 and all(480 % s == 0 for s in sizes)
    assert bench_scaling.rank_sizes(CPU, 7) == [1]
