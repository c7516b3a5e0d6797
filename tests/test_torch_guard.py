"""Guards of the port: it never loads jax or the JAX package, it never falls
back to the CPU when CUDA was asked for, and on a card its kernels equal
the plain torch versions bit for bit.

This file imports no jax and uses no conftest fixture, so the tests marked
``gpu`` run on a machine with a card and without jax:
``python -m pytest --noconftest -m gpu tests/test_torch_guard.py``. Where
``torch.cuda.is_available()`` is False they skip.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu_torch import _kernels
from steroscopic_hardware_tpu_torch.ops import sad, sgm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX_SCRIPT = r"""
import importlib, json, pkgutil, sys, urllib.request
import numpy as np
import torch
import steroscopic_hardware_tpu_torch as port
from steroscopic_hardware_tpu_torch.__main__ import build_app
from steroscopic_hardware_tpu_torch.models.blockmatch import (
    BlockMatcher, SGMMatcher, sgm_serve_step)

for mod in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(mod.name)
rng = np.random.default_rng(7)
left = rng.integers(0, 256, (16, 40), dtype=np.uint8)
right = np.roll(left, -2, axis=1)
depth = BlockMatcher(device="cpu").compute_serve_async(
    [(left, right)], colorize_dev=False).result()
assert depth.shape == (1, 16, 40), depth.shape
depth = SGMMatcher(device="cpu").compute_serve_async(
    [(left, right)], lr=True, colorize_dev=False).result()
assert depth.shape == (1, 16, 40), depth.shape
stacked = torch.from_numpy(np.stack([np.stack((left, right))]))
packed = sgm_serve_step(stacked, max_disparity=16, p1=1.0, p2=8.0,
                        subpixel=True)
assert packed.shape == (4, 16, 40), packed.shape
from steroscopic_hardware_tpu_torch.vo import main as vo_main
assert vo_main(["--synthetic", "--device", "cpu", "--size", "96", "160",
                "--frames", "2", "--max-disparity", "16", "--block", "5",
                "--trajectory", "straight"]) == 0
assert vo_main(["--synthetic", "--device", "cpu", "--size", "96", "160",
                "--frames", "3", "--max-disparity", "16", "--block", "5",
                "--trajectory", "straight", "--slam", "--loop-closure",
                "--kf-every", "1"]) == 0
for flags in (["--backend", "auto"], ["--backend", "sgm"], ["--slam"]):
    app = build_app(["--device", "cpu", "--port", "0", "--no-open",
                     *flags]).start()
    try:
        with urllib.request.urlopen(app.url + "/params", timeout=5) as r:
            assert json.load(r) == {"blockSize": 16, "maxDisparity": 64}
    finally:
        app.shutdown()
print("foreign modules:", sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or (
        m.split(".")[0] == "steroscopic_hardware_tpu")))
"""


def test_port_never_imports_jax():
    """Every module of the port, a CPU SAD and SGM serve step, a two-frame
    CPU visual odometry run, a three-frame SLAM run with loop closure and
    the server with both backends (and with --slam) load neither jax nor
    any module of the JAX package."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "foreign modules: []" in proc.stdout, proc.stdout


_BLOCK_JAX = r"""
import sys


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "steroscopic_hardware_tpu"):
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, _Block())
"""


def test_parallel_ranks_never_import_jax(tmp_path):
    """``python -m steroscopic_hardware_tpu_torch.parallel --world 2
    --device cpu`` with jax and the JAX package made unimportable in the
    launcher and in every rank (a ``sitecustomize`` on the PYTHONPATH,
    which spawned ranks inherit): the dry run still runs and agrees."""
    (tmp_path / "sitecustomize.py").write_text(_BLOCK_JAX)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(tmp_path), REPO, env.get("PYTHONPATH", "")])
    blocked = subprocess.run([sys.executable, "-c", "import jax"], env=env,
                             capture_output=True, text=True, timeout=60)
    assert "is blocked in this process" in blocked.stderr, blocked.stderr
    proc = subprocess.run(
        [sys.executable, "-m", "steroscopic_hardware_tpu_torch.parallel",
         "--world", "2", "--device", "cpu"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["ok"] and line["world"] == 2, line


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the no-fallback rule needs one "
                    "without")


def test_blockmatcher_cuda_raises_without_a_gpu():
    _no_cuda()
    from steroscopic_hardware_tpu_torch.models.blockmatch import BlockMatcher

    with pytest.raises(RuntimeError, match="cuda"):
        BlockMatcher(device="cuda")


def test_main_device_cuda_raises_without_a_gpu():
    _no_cuda()
    from steroscopic_hardware_tpu_torch.__main__ import build_app

    with pytest.raises(RuntimeError, match="cuda"):
        build_app(["--device", "cuda", "--port", "0", "--no-open"])
    # and cuda is the default device
    with pytest.raises(RuntimeError, match="cuda"):
        build_app(["--port", "0", "--no-open"])


def test_stereo_vo_cuda_raises_without_a_gpu():
    _no_cuda()
    from steroscopic_hardware_tpu_torch.models.slam import (
        StereoCamera,
        StereoVO,
    )
    from steroscopic_hardware_tpu_torch.vo import main as vo_main

    cam = StereoCamera(fx=240.0, fy=240.0, cx=160.0, cy=120.0, baseline=0.4)
    with pytest.raises(RuntimeError, match="cuda"):
        StereoVO(cam, device="cuda")
    # and cuda is the default device, of the class and of the entry point
    with pytest.raises(RuntimeError, match="cuda"):
        StereoVO(cam)
    with pytest.raises(RuntimeError, match="cuda"):
        vo_main(["--synthetic", "--frames", "2", "--size", "64", "96"])


def test_stereo_slam_cuda_raises_without_a_gpu():
    _no_cuda()
    from steroscopic_hardware_tpu_torch.__main__ import build_app
    from steroscopic_hardware_tpu_torch.models.slam import (
        StereoCamera,
        StereoSLAM,
    )

    cam = StereoCamera(fx=240.0, fy=240.0, cx=160.0, cy=120.0, baseline=0.4)
    with pytest.raises(RuntimeError, match="cuda"):
        StereoSLAM(cam, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        StereoSLAM(cam, loop_closure=True)  # cuda is the default
    with pytest.raises(RuntimeError, match="cuda"):
        build_app(["--slam", "--port", "0", "--no-open"])


def test_kernel_build_dir(monkeypatch, tmp_path):
    """The library builds into the checkout's build/kernels, into the
    override when one is set, and, for an installed package, into a
    per-user cache, never beside the installed package."""
    monkeypatch.delenv("STEROSCOPIC_KERNEL_DIR", raising=False)
    assert _kernels.build_dir() == os.path.join(REPO, "build", "kernels")
    monkeypatch.setattr(_kernels, "_PKG_DIR", str(
        tmp_path / "site-packages" / "steroscopic_hardware_tpu_torch"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _kernels.build_dir() == str(
        tmp_path / "cache" / "steroscopic_hardware_tpu_torch" / "kernels")
    monkeypatch.setenv("STEROSCOPIC_KERNEL_DIR", str(tmp_path / "k"))
    assert _kernels.build_dir() == str(tmp_path / "k")


# -- on the card --------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _pair(seed, shape, shift=5):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, shape, dtype=np.uint8)
    right = np.clip(np.roll(left, -shift, axis=-1).astype(int)
                    + rng.integers(-3, 4, shape), 0, 255).astype(np.uint8)
    return torch.from_numpy(left), torch.from_numpy(right)


@pytest.mark.gpu
@pytest.mark.parametrize("frames,h,w,block,maxd", [
    (1, 20, 26, 3, 16), (1, 33, 31, 31, 16), (1, 48, 64, 5, 256),
    (1, 37, 130, 16, 64), (3, 70, 300, 9, 48),
    (1, 40, 600, 63, 511),  # the launcher's envelope edge
    # the sweep's edges: W not a multiple of its 128-column strip, W < maxD,
    # right-map columns drifting across the right edge, a one-pixel frame
    (1, 64, 300, 16, 64), (1, 40, 50, 7, 128), (1, 50, 200, 9, 100),
    (2, 1, 1, 3, 4),
])
def test_kernels_equal_plain(cuda, frames, h, w, block, maxd):
    L, R = _pair(frames, (frames, h, w))
    L, R = L.to(cuda), R.to(cuda)
    kw = dict(block_size=block, max_disparity=maxd)
    got = sad.disparity_batch(L, R, **kw)
    assert torch.equal(got, sad.disparity_plain(L, R, **kw))
    for with_costs in (False, True):
        got = sad.disparity_lr(L, R, with_costs=with_costs, **kw)
        want = sad.disparity_raw_lr_plain(L, R, with_costs=with_costs, **kw)
        assert len(got) == len(want)
        for g, wnt in zip(got, want):
            assert torch.equal(g, wnt)


def _stacked(seed, frames, h, w, device):
    """(L, R) as the planes of one (frames, 2, h, w) upload: frames 2 h w
    bytes apart, as the server stacks a batch."""
    L, R = _pair(seed, (frames, h, w))
    both = torch.stack([L, R], dim=1).to(device)
    return both[:, 0], both[:, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("frames,h,w,block,maxd", [
    (4, 40, 300, 16, 64), (3, 21, 131, 63, 511), (4, 9, 37, 7, 128)])
def test_kernels_equal_plain_on_strided_frames(cuda, frames, h, w, block,
                                               maxd):
    L, R = _stacked(frames, frames, h, w, cuda)
    assert L.stride(0) == 2 * h * w
    kw = dict(block_size=block, max_disparity=maxd)
    assert torch.equal(sad.disparity_batch(L, R, **kw),
                       sad.disparity_plain(L, R, **kw))
    for with_costs in (False, True):
        got = sad.disparity_lr(L, R, with_costs=with_costs, **kw)
        want = sad.disparity_raw_lr_plain(L, R, with_costs=with_costs, **kw)
        assert all(torch.equal(g, x) for g, x in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,costs", [("sad_wta", False),
                                          ("sad_lr", False), ("sad_lr", True)])
def test_every_sad_plan_equals_plain(cuda, kernel, costs):
    """Each kernel under every launch plan it compiles, called through the
    library, on a ragged strided batch."""
    F, h, w, b, d = 2, 37, 300, 9, 100
    L, R = _stacked(5, F, h, w, cuda)
    kw = dict(block_size=b, max_disparity=d)
    if kernel == "sad_wta":
        want = [sad.disparity_plain(L, R, **kw)]
    else:
        want = sad.disparity_raw_lr_plain(L, R, with_costs=costs, **kw)
    lib = _kernels._ready(L.device)  # sad_init: the shared-memory opt-in
    stream = torch.cuda.current_stream(cuda).cuda_stream
    name = "sad_lr_costs" if costs else kernel
    plans = [(kv, th, ds) for kv, ths in _kernels.SAD_COMPILED[name].items()
             for th in ths for ds in ((1,) if costs else _kernels.SAD_DS)]
    for plan in plans:
        outs = [torch.empty_like(x) for x in want]
        ptrs = [o.data_ptr() for o in outs]
        args = (L.stride(0), R.stride(0), F, h, w, b, d)
        if kernel == "sad_wta":
            err = lib.sad_wta(L.data_ptr(), R.data_ptr(), *ptrs, *args, *plan,
                              stream)
        else:
            err = lib.sad_lr(L.data_ptr(), R.data_ptr(), *ptrs,
                             *[None] * (5 - len(ptrs)), *args, int(costs),
                             *plan, stream)
        assert err == 0, plan
        assert all(torch.equal(o, x) for o, x in zip(outs, want)), plan


@pytest.mark.gpu
def test_sad_library_refuses_plans_it_has_not_compiled(cuda):
    L, R = _pair(0, (1, 16, 32))
    L, R = L.to(cuda), R.to(cuda)
    lib = _kernels._ready(L.device)  # sad_init: the shared-memory opt-in
    stream = torch.cuda.current_stream(cuda).cuda_stream
    out = torch.empty_like(L)
    maps = [torch.empty(L.shape, dtype=torch.int32, device=cuda)
            for _ in range(5)]
    ptrs = [m.data_ptr() for m in maps]
    for kv, th, ds, d in ((4, 8, 1, 16), (8, 3, 1, 16), (8, 8, 3, 16),
                          (8, 8, 8, 16), (8, 8, 4, 2), (5, 8, 1, 16),
                          (8, 16, 1, 16)):
        assert lib.sad_wta(L.data_ptr(), R.data_ptr(), out.data_ptr(), 512,
                           512, 1, 16, 32, 5, d, kv, th, ds, stream) != 0
    for costs, kv, th, ds in ((0, 4, 4, 1), (0, 8, 8, 1), (1, 4, 8, 1),
                              (1, 4, 4, 2), (0, 8, 4, 8), (1, 8, 4, 1)):
        assert lib.sad_lr(L.data_ptr(), R.data_ptr(), *ptrs, 512, 512, 1, 16,
                          32, 5, 16, costs, kv, th, ds, stream) != 0
    assert lib.sad_wta(L.data_ptr(), R.data_ptr(), out.data_ptr(), 512, 512,
                       1, 16, 32, 5, 16, 8, 8, 2, stream) == 0


@pytest.mark.gpu
def test_parallel_ranks_launch_the_kernels(cuda):
    """Two gloo ranks on the card (``parallel.dryrun.launch_cases``): the
    sharded SAD and SGM gathered equal one process bit for bit, and each
    rank launched sad_wta once, and sgm_transpose_add once, sgm_aggregate
    twice and sgm_epilogue once, for its frame."""
    from steroscopic_hardware_tpu_torch.parallel import dryrun

    left, right = (a.numpy() for a in _pair(11, (96, 200)))
    cases = [("sad", dict(kind="sad", left=left, right=right, block_size=9,
                          max_disparity=32)),
             ("sgm", dict(kind="sgm", left=left, right=right,
                          max_disparity=32))]
    got = dryrun.launch_cases(cases, 2, backend="gloo", device="cuda")
    want = dryrun.single_rank(cases, cuda)
    expect = {"sad": {"sad_wta": 1},
              "sgm": {"sgm_transpose_add": 1, "sgm_aggregate": 2,
                      "sgm_epilogue": 1}}
    for name, launches in expect.items():
        np.testing.assert_array_equal(got[name]["disp"], want[name]["disp"])
        for rank in got[name]["ranks"]:
            assert {k: v for k, v in rank["launches"].items() if v} \
                == launches, rank


@pytest.mark.gpu
def test_serve_path_launches_the_kernels(cuda):
    from steroscopic_hardware_tpu_torch.models.blockmatch import BlockMatcher

    L, R = _pair(0, (2, 40, 96))
    pairs = [(L[b].numpy(), R[b].numpy()) for b in range(2)]
    m = BlockMatcher(device=cuda)
    _kernels.reset_launches()
    fut = m.compute_serve_async(pairs, colorize_dev=False)
    got = fut.result()
    assert fut.device_ms() > 0
    got_lr = m.compute_serve_async(pairs, lr=True, colorize_dev=False).result()
    assert _kernels.launches == {"sad_wta": 1, "sad_lr": 1,
                                 "sgm_aggregate": 0, "sgm_transpose_add": 0,
                                 "sgm_epilogue": 0}
    want = sad.disparity_plain(L, R, block_size=16, max_disparity=64)
    assert np.array_equal(got, want.numpy())
    assert got_lr.shape == got.shape


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,block,maxd", [
    (40, 64, 7, 16), (33, 80, 5, 32), (24, 50, 9, 48), (17, 45, 3, 48),
    (376, 1241, 9, 128),  # KITTI odometry's frame, the VO path's shape
])
def test_disparity_subpixel_equals_plain(cuda, h, w, block, maxd):
    """B2s: sad_lr with costs and the parabola on the card equal the plain
    sweep and parabola on the same device, exactly."""
    L, R = _pair(h, (h, w))
    L, R = L.to(cuda), R.to(cuda)
    kw = dict(block_size=block, max_disparity=maxd)
    _kernels.reset_launches()
    got = sad.disparity_subpixel(L, R, **kw)
    assert _kernels.launches["sad_lr"] == 1
    want = sad.disparity_subpixel_plain(L, R, **kw)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_stereo_vo_launches_sad_lr_once_a_frame(cuda):
    """StereoVO on the card runs every frame's disparity through sad_lr
    and tracks a synthetic sequence as the CPU run does (the two draw
    their RANSAC scores from different generators)."""
    from steroscopic_hardware_tpu_torch.models.slam import StereoVO, ate_rmse
    from steroscopic_hardware_tpu_torch.vo import synthetic_sequence

    cam, pairs, gt = synthetic_sequence(4, trajectory="straight",
                                        size=(120, 400))
    kw = dict(block_size=7, max_disparity=48, max_keypoints=128,
              fast_threshold=15)
    vo = StereoVO(cam, device=cuda, **kw)
    _kernels.reset_launches()
    for left, right in pairs:
        vo.process(left, right)
    assert _kernels.launches["sad_lr"] == len(pairs)
    cpu = StereoVO(cam, device="cpu", **kw)
    for left, right in pairs:
        cpu.process(left, right)
    assert min(vo.n_inliers[1:]) >= 15 and vo.tracking_drops == 0
    assert np.abs(vo.positions() - cpu.positions()).max() < 2e-3
    assert ate_rmse(vo.positions(), gt) < 0.02


@pytest.mark.gpu
def test_stereo_slam_and_fused_step_on_the_card(cuda):
    """StereoSLAM on the card (windowed BA, BoW loop closure and the pose
    graph solving on the card) runs its backend there as on the CPU, its
    window solve and pose graph equal the CPU's on the same inputs, and
    the fused serve+track step launches sad_wta once for the serve and
    sad_lr (with costs) once per tracked frame, its serve half equal to
    the unfused serve. The trajectories themselves are not compared: the
    card and the CPU draw different RANSAC scores, and on this small frame
    the closures they find moved a mid-sequence pose by 0.126 m."""
    from steroscopic_hardware_tpu_torch.models.blockmatch import BlockMatcher
    from steroscopic_hardware_tpu_torch.models.slam import (
        StereoSLAM,
        pose_graph_optimize,
    )
    from steroscopic_hardware_tpu_torch.runtime.fused import (
        FusedServeTrack,
        split_serve,
    )
    from steroscopic_hardware_tpu_torch.utils.params import Parameters
    from steroscopic_hardware_tpu_torch.vo import synthetic_sequence

    cam, pairs, _ = synthetic_sequence(12, trajectory="loop",
                                       size=(120, 400))
    kw = dict(block_size=7, max_disparity=48, max_keypoints=128,
              fast_threshold=15, window=3, kf_every=1, loop_closure=True,
              loop_min_matches=25, loop_gap=4)
    engines = {dev: StereoSLAM(cam, device=dev, **kw)
               for dev in (cuda, "cpu")}
    for engine in engines.values():
        for left, right in pairs:
            engine.process(left, right)
    card, cpu = engines[cuda], engines["cpu"]
    assert card.device.type == "cuda" and card.backend_errors == 0
    assert card.ba_runs == cpu.ba_runs >= 1 and card.loops_closed >= 1
    kfs = list(cpu.keyframes)
    xi0 = np.stack([kf.xi_world for kf in kfs]).astype(np.float32)
    np.testing.assert_allclose(card._solve_window(kfs, xi0),
                               cpu._solve_window(kfs, xi0), atol=1e-4)
    graph = (np.stack([kf.xi_world for kf, _ in cpu.kf_history]),
             np.array([(i, j) for i, j, _ in cpu.graph_edges]),
             np.stack([m for _, _, m in cpu.graph_edges]),
             np.ones(len(cpu.graph_edges), np.float32))
    solved = [pose_graph_optimize(*(torch.from_numpy(np.asarray(
        a, np.float32 if a.dtype.kind == "f" else np.int64)).to(dev)
        for a in graph), iters=10)[0].cpu().numpy()
        for dev in (cuda, "cpu")]
    # chip_smoke.py's PG_XI_TOL: sound solves of 32 loop graphs read up to
    # 1.2e-4, graphs with bfloat16 measurements from 9.9e-3 (PERF.md)
    np.testing.assert_allclose(solved[0], solved[1], atol=1e-3)

    matcher = BlockMatcher(device=cuda)
    matcher.set_params(Parameters(block_size=7, max_disparity=48))
    fused = FusedServeTrack(matcher, StereoSLAM(cam, device=cuda, **kw))
    _kernels.reset_launches()
    flat, track = fused.step(pairs[:3], fetch_all=True, colorize_dev=False)
    assert _kernels.launches["sad_wta"] == 1
    assert _kernels.launches["sad_lr"] == 3
    depths, _ = split_serve(flat, 3, 120, 400, fetch_all=True,
                            colorize_dev=False)
    want = matcher.compute_serve_async(pairs[:3], fetch_all=True,
                                       colorize_dev=False).result()
    assert np.array_equal(depths, want)
    assert track.bow_vec is not None and len(track.host_features()) == 6


@pytest.mark.gpu
def test_launcher_rejects_bad_inputs(cuda):
    L, R = _pair(0, (1, 16, 32))
    L, R = L.to(cuda), R.to(cuda)
    with pytest.raises(ValueError, match="uint8"):
        _kernels.sad_wta(L.int(), R.int(), 5, 16)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.sad_wta(L.transpose(1, 2), R.transpose(1, 2), 5, 16)
    with pytest.raises(ValueError, match="block_size"):
        _kernels.sad_wta(L, R, 65, 16)
    with pytest.raises(ValueError, match="max_disparity"):
        _kernels.sad_lr(L, R, 5, 512)


def _volume(seed, shape, high=25):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, high, shape, dtype=np.uint8))


# (D, S, K): the launch plan's edges (D at each boundary of the lanes per
# column and of the compiled chunk sizes; S of 1, 2 and odd, for the middle
# row; K ragged against a warp's and a block's columns) beside volumes of
# the served shapes
AGGREGATE_SHAPES = [
    (17, 37, 53), (17, 53, 37), (257, 40, 300), (65, 1080, 64),
    (1, 7, 33), (2, 2, 45), (20, 1, 40), (21, 3, 31), (33, 2, 65),
    (36, 5, 17), (37, 9, 33), (40, 4, 31), (41, 11, 50), (65, 1, 100),
    (72, 3, 21), (73, 6, 5), (129, 7, 13), (136, 2, 7), (137, 13, 9),
    (144, 2, 3), (145, 9, 11), (257, 5, 6), (272, 3, 35), (273, 4, 3),
    (288, 11, 19)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", AGGREGATE_SHAPES)
@pytest.mark.parametrize("in_dtype,out_dtype,P", [
    (torch.uint8, torch.uint8, (1.0, 8.0)),
    (torch.bfloat16, torch.uint8, (1.0, 8.0)),
    (torch.bfloat16, torch.bfloat16, (1.0, 8.0)),
    (torch.uint8, torch.bfloat16, (1.0, 8.0)),
    (torch.uint8, torch.float32, (0.7, 5.3)),
    (torch.bfloat16, torch.float32, (0.7, 5.3))])
def test_sgm_aggregate_equals_plain(cuda, shape, in_dtype, out_dtype, P):
    cost = _volume(0, shape).to(cuda).to(in_dtype)
    got = sgm.aggregate_axis(cost, *P, out_dtype=out_dtype)
    want = sgm.aggregate_axis_plain(cost, *P, out_dtype=out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(17, 37, 53), (257, 40, 300)])
def test_sgm_transpose_add_and_epilogue_equal_plain(cuda, shape):
    aT = _volume(1, shape).to(cuda)
    want = sgm.transpose_add_plain(aT, out_dtype=torch.bfloat16)
    assert torch.equal(sgm.transpose_add(aT, out_dtype=torch.bfloat16), want)
    b = _volume(2, want.shape).to(cuda).to(torch.bfloat16)
    a16 = aT.to(torch.bfloat16)
    f32 = torch.float32
    assert torch.equal(sgm.transpose_add(a16, b, out_dtype=f32),
                       sgm.transpose_add_plain(a16, b, out_dtype=f32))
    D, H, W = shape
    agg_v = _volume(3, (D, H, W), high=120).to(cuda)
    agg_ht = _volume(4, (D, W, H), high=120).to(cuda)
    for subpixel in (False, True):
        got = sgm.sgm_epilogue(agg_v, agg_ht, subpixel=subpixel)
        plain = sgm.sgm_epilogue_plain(agg_v, agg_ht, subpixel=subpixel)
        assert torch.equal(got, plain)


u8, bf16, f32 = torch.uint8, torch.bfloat16, torch.float32
# B4's type combinations: (aT / b dtype, out dtype, with b)
TRANSPOSE_FORMS = [(u8, bf16, False), (bf16, bf16, True), (bf16, f32, True),
                   (f32, f32, True), (u8, f32, True), (f32, bf16, False)]


def _offset_volume(seed, shape, dtype, offset, device, high=120):
    """A contiguous volume whose base lies ``offset`` bytes past a 16-byte
    boundary (a view into a larger allocation)."""
    n = int(np.prod(shape))
    size = torch.empty((), dtype=dtype).element_size()
    flat = _volume(seed, (n + 16,), high).to(device).to(dtype)
    view = flat[offset // size:offset // size + n].view(shape)
    assert view.data_ptr() % 16 == offset and view.is_contiguous()
    return view


def _check_transpose(aT, b, out_dtype):
    got = sgm.transpose_add(aT, b, out_dtype=out_dtype)
    want = sgm.transpose_add_plain(aT, b, out_dtype=out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("form", TRANSPOSE_FORMS)
@pytest.mark.parametrize("offset", [0, 8, 4, 2, 1])
def test_sgm_transpose_add_at_each_access_width(cuda, form, offset):
    """aT and b at base pointers 16, 8, 4, 2 and 1 bytes aligned, so that
    the plan takes each width the element size allows for both."""
    ind, outd, has_b = form
    size = torch.empty((), dtype=ind).element_size()
    if offset % size:
        pytest.skip("a torch tensor's base is a multiple of its element size")
    D, B, A = 3, 72, 1920
    aT = _offset_volume(1, (D, B, A), ind, offset, cuda)
    b = _offset_volume(2, (D, A, B), ind, offset, cuda) if has_b else None
    plan = _kernels.transpose_add_plan(D, B, A, ind, outd, has_b, 132,
                                       offset or 16, offset or 16, 16)
    assert plan.wa == max(size, offset or 16)
    assert plan.wb == (min(8 * size, offset or 16) if has_b else 0)
    _check_transpose(aT, b, outd)


@pytest.mark.gpu
@pytest.mark.parametrize("form", TRANSPOSE_FORMS)
@pytest.mark.parametrize("shape", [
    (1, 1, 1), (1, 53, 37), (2, 38, 130), (5, 36, 257), (3, 65, 129),
    (2, 100, 20), (7, 130, 66), (1, 1920, 1080), (4, 64, 128)])
def test_sgm_transpose_add_ragged_edges(cuda, form, shape):
    """Tiles cut by the volume's edges (A, B not multiples of the tile),
    out rows of every store width (B odd, 2 and 4 mod 8, and a multiple of
    8) and D = 1."""
    ind, outd, has_b = form
    D, B, A = shape
    aT = _volume(3, shape, 120).to(cuda).to(ind)
    b = _volume(4, (D, A, B), 120).to(cuda).to(ind) if has_b else None
    _check_transpose(aT, b, outd)


@pytest.mark.gpu
def test_sgm_transpose_add_on_views(cuda):
    """A strided view made contiguous, and contiguous views at an offset
    into their allocation (the 1080-row uint8 cost volume among them)."""
    wide = _volume(5, (3, 40, 2 * 1080 + 3)).to(cuda)
    aT = wide[:, :, 3::2].contiguous()
    assert aT.shape == (3, 40, 1080)
    _check_transpose(aT, None, bf16)
    aT = _offset_volume(6, (2, 40, 1080), u8, 8, cuda, high=25)
    _check_transpose(aT, None, bf16)
    a16 = _offset_volume(7, (2, 40, 1080), bf16, 4, cuda)
    b16 = _offset_volume(8, (2, 1080, 40), bf16, 2, cuda)
    _check_transpose(a16, b16, bf16)
    _check_transpose(a16, b16, f32)


@pytest.mark.gpu
def test_sgm_transpose_add_1080p_d64(cuda):
    """The served cost form: 1080-byte uint8 rows (8-byte loads) into
    1920-wide bfloat16 rows."""
    cost_t = _volume(9, (65, 1920, 1080), 25).to(cuda)
    plan = _kernels.transpose_add_plan(65, 1920, 1080, u8, bf16, False, 132)
    assert plan.wa == 8 and plan.wo == 16
    _check_transpose(cost_t, None, bf16)


@pytest.mark.gpu
def test_sgm_library_refuses_uncompiled_transpose_plans(cuda):
    """The C entry point takes only the plans it compiled: access widths
    that are powers of two from the element size to 16 bytes (b's up to 8
    elements) dividing pitch and pointer, the exact grid; the wrapper
    raises on a refusal."""
    lib = _kernels.load()
    D, B, A = 4, 72, 1920
    aT = _volume(0, (D, B, A)).to(cuda)
    a16 = aT.to(bf16)
    b16 = _volume(1, (D, A, B)).to(cuda).to(bf16)
    out = torch.empty((D, A, B), dtype=bf16, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    cost = _kernels.transpose_add_plan(D, B, A, u8, bf16, False, 132)
    summed = _kernels.transpose_add_plan(D, B, A, bf16, bf16, True, 132)

    def call(a, b, plan, in_type):
        return lib.sgm_transpose_add(
            a.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), D, B, A, in_type, 1, *plan[:4], *plan.grid,
            stream)

    assert call(aT, None, cost, 0) == 0
    assert call(a16, b16, summed, 1) == 0
    for plan in (cost._replace(wa=32), cost._replace(wa=3),
                 cost._replace(wb=4), cost._replace(wo=1),
                 cost._replace(wo=32), cost._replace(dpb=0),
                 cost._replace(grid=(cost.grid[0] + 1,) + cost.grid[1:]),
                 cost._replace(grid=cost.grid[:2] + (cost.grid[2] + 1,))):
        assert call(aT, None, plan, 0) != 0, plan
    for plan in (summed._replace(wa=1), summed._replace(wb=0),
                 summed._replace(wb=32)):
        assert call(a16, b16, plan, 1) != 0, plan
    # a width the pointer's alignment does not allow
    view = _offset_volume(2, (D, B, A), u8, 4, cuda)
    assert call(view, None, cost, 0) != 0
    # an unknown output type
    assert lib.sgm_transpose_add(aT.data_ptr(), None, out.data_ptr(), D, B,
                                 A, 0, 0, *cost[:4], *cost.grid, stream) != 0
    with pytest.raises(RuntimeError, match="sgm_transpose_add launch failed"):
        _kernels._raise_on(lib, call(view, None, cost, 0),
                           "sgm_transpose_add")


EPILOGUE_TIERS = [u8, bf16, f32]


def _check_epilogue(agg_v, agg_ht):
    for subpixel in (False, True):
        got = sgm.sgm_epilogue(agg_v, agg_ht, subpixel=subpixel)
        want = sgm.sgm_epilogue_plain(agg_v, agg_ht, subpixel=subpixel)
        assert got.dtype == f32 and torch.equal(got, want), subpixel


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", EPILOGUE_TIERS)
@pytest.mark.parametrize("shape", [
    (1, 1, 1), (1, 37, 53), (2, 64, 64), (3, 65, 129), (7, 130, 66),
    (288, 70, 45), (65, 1080, 960), (9, 1080, 480), (17, 1080, 240),
    (5, 2, 700)])
def test_sgm_epilogue_equals_plain(cuda, dtype, shape):
    """B5 == plain exactly, integer and subpixel: ragged tile edges, D 1
    and 288, and the W-bands of the sharded engine."""
    D, H, W = shape
    agg_v = _volume(10, (D, H, W), high=120).to(cuda).to(dtype)
    agg_ht = _volume(11, (D, W, H), high=120).to(cuda).to(dtype)
    _check_epilogue(agg_v, agg_ht)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", EPILOGUE_TIERS)
@pytest.mark.parametrize("offset", [0, 8, 4, 2, 1])
def test_sgm_epilogue_at_each_access_width(cuda, dtype, offset):
    """agg_v and agg_ht at base pointers 16, 8, 4, 2 and 1 bytes aligned,
    on rows whose pitch allows 16 bytes, so that the plan takes each width
    the element size allows for both; and the 1080-byte uint8 rows of
    agg_ht at 1080 rows (8-byte loads)."""
    size = torch.empty((), dtype=dtype).element_size()
    if offset % size:
        pytest.skip("a torch tensor's base is a multiple of its element size")
    D, H, W = 5, 80, 208
    agg_v = _offset_volume(12, (D, H, W), dtype, offset, cuda)
    agg_ht = _offset_volume(13, (D, W, H), dtype, offset, cuda)
    plan = _kernels.sgm_epilogue_plan(D, H, W, dtype, offset or 16,
                                      offset or 16)
    assert plan.wv == plan.wh == max(size, offset or 16)
    _check_epilogue(agg_v, agg_ht)
    agg_v = _offset_volume(14, (3, 1080, 64), dtype, offset, cuda)
    agg_ht = _offset_volume(15, (3, 64, 1080), dtype, offset, cuda)
    _check_epilogue(agg_v, agg_ht)


@pytest.mark.gpu
def test_sgm_epilogue_every_ring_and_width(cuda):
    """Every ring depth compiled for each type and every access width the
    shape allows, through the library, equal to the wrapper's output."""
    lib = _kernels.load()
    D, H, W = 9, 72, 200
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for dt in EPILOGUE_TIERS:
        s = torch.empty((), dtype=dt).element_size()
        agg_v = _volume(16, (D, H, W), high=120).to(cuda).to(dt)
        agg_ht = _volume(17, (D, W, H), high=120).to(cuda).to(dt)
        want = sgm.sgm_epilogue_plain(agg_v, agg_ht, subpixel=True)
        chosen = _kernels.sgm_epilogue_plan(D, H, W, dt)
        ws = [w for w in (1, 2, 4, 8, 16) if w >= s]
        plans = [chosen._replace(stages=n)
                 for n in _kernels.EPILOGUE_RINGS]
        plans += [chosen._replace(wv=w) for w in ws if (W * s) % w == 0]
        plans += [chosen._replace(wh=w) for w in ws if (H * s) % w == 0]
        for plan in plans:
            out = torch.full((H, W), -1.0, device=cuda)
            assert lib.sgm_epilogue(
                agg_v.data_ptr(), agg_ht.data_ptr(), out.data_ptr(), D, H, W,
                _kernels._TYPE_CODES[dt], 1, *plan[:3], *plan.grid,
                stream) == 0, plan
            torch.cuda.synchronize()
            assert torch.equal(out, want), plan


@pytest.mark.gpu
def test_sgm_library_refuses_other_epilogue_plans(cuda):
    """The C entry point takes only plans within sgm_epilogue_plan's
    rules: access widths that are powers of two from the element size to
    16 bytes dividing pitch and pointer, a ring depth the library
    compiled, the exact grid; the wrapper raises on a refusal."""
    lib = _kernels.load()
    D, H, W = 4, 72, 200
    agg_v = _volume(0, (D, H, W)).to(cuda)
    agg_ht = _volume(1, (D, W, H)).to(cuda)
    out = torch.empty((H, W), dtype=f32, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    plan = _kernels.sgm_epilogue_plan(D, H, W, u8)

    def call(v, ht, plan, in_type=0, d=D):
        return lib.sgm_epilogue(v.data_ptr(), ht.data_ptr(), out.data_ptr(),
                                d, H, W, in_type, 1, *plan[:3], *plan.grid,
                                stream)

    assert call(agg_v, agg_ht, plan) == 0
    for bad in (plan._replace(wv=32), plan._replace(wv=3),
                plan._replace(wh=16),  # 72 bytes: 8 divides, 16 does not
                plan._replace(wh=0), plan._replace(stages=5),
                plan._replace(stages=1), plan._replace(stages=0),
                plan._replace(grid=(plan.grid[0] + 1, plan.grid[1])),
                plan._replace(grid=(plan.grid[0], plan.grid[1] - 1))):
        assert call(agg_v, agg_ht, bad) != 0, bad
    # bfloat16 takes no 1-byte access
    v16, ht16 = agg_v.to(bf16), agg_ht.to(bf16)
    assert call(v16, ht16, plan._replace(wv=2), 1) == 0
    assert call(v16, ht16, plan._replace(wv=1), 1) != 0
    # a width the pointer's alignment does not allow; D 0; a bad type
    view = _offset_volume(2, (D, H, W), u8, 4, cuda)
    assert call(view, agg_ht, plan) != 0
    assert call(agg_v, agg_ht, plan, d=0) != 0
    assert call(agg_v, agg_ht, plan, in_type=3) != 0
    with pytest.raises(RuntimeError, match="sgm_epilogue launch failed"):
        _kernels._raise_on(lib, call(view, agg_ht, plan), "sgm_epilogue")


@pytest.mark.gpu
def test_sgm_serve_path_launches_the_kernels(cuda):
    from steroscopic_hardware_tpu_torch.models.blockmatch import SGMMatcher

    L, R = _pair(0, (2, 40, 96))
    pairs = [(L[b].numpy(), R[b].numpy()) for b in range(2)]
    m = SGMMatcher(device=cuda)
    _kernels.reset_launches()
    got = m.compute_serve_async(pairs, colorize_dev=False).result()
    # per frame: B4 on the cost, B3 twice, B4 on the aggregates
    assert _kernels.launches == {"sad_wta": 0, "sad_lr": 0,
                                 "sgm_aggregate": 4, "sgm_transpose_add": 4,
                                 "sgm_epilogue": 0}
    cpu = SGMMatcher(device="cpu")
    assert np.array_equal(
        got, cpu.compute_serve_async(pairs, colorize_dev=False).result())
    got_lr = m.compute_serve_async(pairs, lr=True, colorize_dev=False).result()
    assert np.array_equal(got_lr, cpu.compute_serve_async(
        pairs, lr=True, colorize_dev=False).result())


@pytest.mark.gpu
def test_sgm_launchers_reject_bad_inputs(cuda):
    from steroscopic_hardware_tpu_torch import _kernels as k

    cost = _volume(0, (17, 8, 8)).to(cuda)
    with pytest.raises(ValueError, match="uint8, bfloat16 or float32"):
        k.sgm_aggregate(cost.int(), 1.0, 8.0, torch.uint8)
    with pytest.raises(ValueError, match="contiguous"):
        k.sgm_aggregate(cost.transpose(1, 2), 1.0, 8.0, torch.uint8)
    with pytest.raises(ValueError, match="above the kernel"):
        k.sgm_aggregate(_volume(0, (289, 2, 2)).to(cuda), 1.0, 8.0,
                        torch.uint8)
    # a launch plan the kernel cannot take is refused, not run
    lib, vol = k.load(), _volume(0, (200, 8, 8)).to(cuda)
    out = torch.empty_like(vol)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    lanes = k.sgm_aggregate_plan(17, 8, 8, sms=132)
    staged = k.sgm_aggregate_plan(200, 8, 8, sms=132)
    for D, plan in ((17, lanes._replace(lanes=3)), (17, lanes._replace(dpt=11)),
                    (17, lanes._replace(lanes=1, dpt=9)),
                    (17, lanes._replace(block=96 + 256)),
                    (17, lanes._replace(grid=lanes.grid + 1)),
                    (200, staged._replace(dpt=8)),
                    (200, staged._replace(block=256)),
                    (200, staged._replace(grid=staged.grid + 1)),
                    (289, k.AggregatePlan(1, 32, 10, 512, 1))):
        assert lib.sgm_aggregate(vol.data_ptr(), out.data_ptr(), D, 8, 8, 0,
                                 0, 1.0, 8.0, *plan, stream) != 0, plan
    for D, plan in ((17, lanes), (17, k.AggregatePlan(1, 32, 1, 512, 1)),
                    (200, staged)):
        assert lib.sgm_aggregate(vol.data_ptr(), out.data_ptr(), D, 8, 8, 0,
                                 0, 1.0, 8.0, *plan, stream) == 0, plan
    with pytest.raises(ValueError, match="b must be"):
        k.sgm_transpose_add(cost, cost.to(torch.bfloat16), torch.float32)
    with pytest.raises(ValueError, match="agg_ht must be"):
        k.sgm_epilogue(cost, cost[:, :4], True)


@pytest.mark.gpu
def test_rectified_serve_on_the_card(cuda):
    """A calibrated rig on the card: maps equal to those built on the CPU,
    remap card against CPU within one grey level on at most 1e-4 of the
    pixels, a rectified serve through the kernel equal to the plain SAD of
    the card's rectified frames, and a rectifier on another device than
    the matcher's refused."""
    from steroscopic_hardware_tpu_torch.models.blockmatch import BlockMatcher
    from steroscopic_hardware_tpu_torch.ops.rectify import StereoRectifier
    from steroscopic_hardware_tpu_torch.ops.se3_np import so3_exp

    K = np.array([[150.0, 0, 91.5], [0, 150.0, 66.0], [0, 0, 1]])
    args = (K, (-0.12, 0.03, 5e-4, -3e-4, 0.0), K, (-0.1, 0.02, 0, 0, 0),
            so3_exp(np.array([0.01, -0.02, 0.005])), [-0.12, 0.002, 0.001],
            (120, 160))
    card = StereoRectifier(*args, device=cuda)
    host = StereoRectifier(*args, device="cpu")
    for a, b in zip(card._maps, host._maps):
        assert torch.equal(a.cpu(), b)
    L, R = _pair(3, (3, 136, 180))
    raw = torch.stack([L, R], dim=1)
    got = card.apply(raw.to(cuda)).cpu()
    diff = (got.to(torch.int32) - host.apply(raw).to(torch.int32)).abs()
    assert diff.max() <= 1 and (diff != 0).double().mean() <= 1e-4
    pairs = [(L[b].numpy(), R[b].numpy()) for b in range(3)]
    m = BlockMatcher(device=cuda)
    _kernels.reset_launches()
    served = m.compute_serve_async(pairs, colorize_dev=False,
                                   rectifier=card).result()
    assert _kernels.launches["sad_wta"] == 1
    want = sad.disparity_plain(got[:, 0], got[:, 1], block_size=16,
                               max_disparity=64)
    assert np.array_equal(served, want.numpy())
    with pytest.raises(ValueError, match="rectifier"):
        BlockMatcher(device="cpu").compute_serve_async(pairs, rectifier=card)


_FRESH_SLAM_SCRIPT = r"""
import json, sys, time, urllib.request
import numpy as np
from steroscopic_hardware_tpu_torch.__main__ import build_app
from steroscopic_hardware_tpu_torch.io.png import write_png

rng = np.random.default_rng(0)
left = rng.integers(0, 256, (240, 320), dtype=np.uint8)
write_png(sys.argv[1] + "/l.png", left)
write_png(sys.argv[1] + "/r.png", np.roll(left, -4, axis=1))
app = build_app(["--left", sys.argv[1] + "/l.png", "--right",
                 sys.argv[1] + "/r.png", "--port", "0", "--no-open",
                 "--slam", "--loop-closure", "--cx", "160", "--cy", "120"])
app.start()
try:
    t0 = time.time()
    while True:
        with urllib.request.urlopen(app.url + "/slam", timeout=10) as r:
            snap = json.load(r)
        if snap.get("warm") and snap["frames"] >= 2:
            break
        assert time.time() - t0 < 180, snap
        time.sleep(0.1)
finally:
    app.shutdown()
assert app.slam_pipeline._warm_done and snap["errors"] == 0, snap
assert app.slam_pipeline.slam.backend_errors == 0
print("ok")
"""


@pytest.mark.gpu
def test_slam_server_warms_in_a_fresh_process(cuda, tmp_path):
    """A fresh process: the SLAM boot warmup's BA and the fused step's PnP
    would make the first CUDA linear-algebra calls at once, and torch's
    lazy load of that library fails one of two racing threads; the engine
    makes the first call before its threads start."""
    res = subprocess.run([sys.executable, "-c", _FRESH_SLAM_SCRIPT,
                          str(tmp_path)], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr[-3000:]
    assert "warmup failed" not in res.stderr, res.stderr[-3000:]
