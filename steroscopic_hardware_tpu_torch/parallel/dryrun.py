"""The multi-process tier once over a mesh of ranks (counterpart of
``__graft_entry__.dryrun_multichip``), and the rank function that drives
its sharded operations.

    python -m steroscopic_hardware_tpu_torch.parallel [--world N]
        [--device cuda|cpu] [--backend gloo|nccl] [--size H W]

runs row-band SAD, scanline-sharded SGM, landmark-sharded BA and the
edge-sharded pose graph once each over a (1, N) mesh of N ranks on this
host, on the card unless ``--device cpu``, and prints one JSON line with
each stage's shapes and whether it equals the single-rank result (SAD and
SGM bit for bit; BA and the pose graph within the JAX tests' tolerances,
with the largest difference). ``--backend`` defaults to gloo on the CPU
and nccl on cards; ranks that share a card need ``--backend gloo``.

:func:`run_cases` is the rank function of that run, of the CPU tests and
of ``chip_smoke.py``'s phase 9: each rank runs a list of named cases (numpy
inputs, the same list on every rank), cuts its own shard, runs the sharded
operation, gathers the result, and rank 0 writes every case's gathered
outputs with each rank's seconds, kernel launches and bytes sent.
"""

from __future__ import annotations

import argparse
import json
import pickle
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from steroscopic_hardware_tpu_torch import _kernels
from steroscopic_hardware_tpu_torch.parallel import multihost
from steroscopic_hardware_tpu_torch.parallel.multihost import (
    all_gather,
    shard,
)

BA_INTR = (100.0, 100.0, 64.0, 48.0)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _frame(case, key, mesh, dev):
    """The case's (H, W) image, or this batch rank's frame of an (F, H, W)
    stack, on the rank's device."""
    a = case[key]
    if a.ndim == 3:
        a = a[mesh.get_local_rank("batch")]
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _join_batch(out, case, mesh):
    """The batch ranks' maps stacked when the case is a frame stack."""
    if case["left"].ndim == 3:
        return all_gather(out[None], mesh, "batch")
    return out


def _timed(dev, fn):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _run_sad(case, mesh, dev):
    from steroscopic_hardware_tpu_torch.parallel.disparity_shard import (
        disparity_sharded,
    )

    # the rank's band only: the halo must come through the exchange
    left = shard(_frame(case, "left", mesh, dev), mesh)
    right = shard(_frame(case, "right", mesh, dev), mesh)
    out, s = _timed(dev, lambda: disparity_sharded(
        left, right, block_size=case["block_size"],
        max_disparity=case["max_disparity"], mesh=mesh))
    return {"disp": _join_batch(all_gather(out, mesh), case, mesh)}, s


def _run_sgm(case, mesh, dev):
    from steroscopic_hardware_tpu_torch.parallel.sgm_shard import (
        sgm_disparity_sharded,
    )

    left = _frame(case, "left", mesh, dev)
    right = _frame(case, "right", mesh, dev)
    out, s = _timed(dev, lambda: sgm_disparity_sharded(
        left, right, max_disparity=case["max_disparity"],
        subpixel=case.get("subpixel", True), mesh=mesh))
    return {"disp": _join_batch(all_gather(out, mesh, dim=1), case, mesh)}, s


def _run_ba(case, mesh, dev):
    from steroscopic_hardware_tpu_torch.parallel.ba_dist import (
        ba_solve_sharded,
    )

    def t(key):
        return torch.from_numpy(case[key]).to(dev)

    xi = t("xi")
    pts, uv, mask = (shard(t("points"), mesh), shard(t("uv"), mesh, dim=1),
                     shard(t("mask"), mesh, dim=1))
    (xi, pts, errs), s = _timed(dev, lambda: ba_solve_sharded(
        xi, pts, uv, mask, intr=tuple(case["intr"]), mesh=mesh,
        iters=case["iters"]))
    return {"xi": xi, "points": all_gather(pts, mesh), "errs": errs}, s


def _run_pg(case, mesh, dev):
    from steroscopic_hardware_tpu_torch.parallel.pg_dist import (
        pad_edges,
        pose_graph_optimize_sharded,
    )

    n = mesh.get_group("rows").size()
    arrays = pad_edges(case["edges"], case["meas"], case["w"], n)
    edges, meas, w = (shard(torch.from_numpy(a).to(dev), mesh)
                      for a in arrays)
    nodes = torch.from_numpy(case["nodes"]).to(dev)
    (xi, costs), s = _timed(dev, lambda: pose_graph_optimize_sharded(
        nodes, edges, meas, w, mesh=mesh, iters=case["iters"]))
    return {"xi": xi, "costs": costs}, s


def _run_slam(case, mesh, dev):
    """StereoSLAM(pg_mesh=) over a synthetic sequence rendered in the rank
    (``vo.synthetic_sequence``): each rank's camera centres, keyframes and
    closures, gathered as ``per_rank``."""
    from steroscopic_hardware_tpu_torch.models.slam import StereoSLAM
    from steroscopic_hardware_tpu_torch.vo import (
        run_slam,
        synthetic_sequence,
    )

    cam, pairs, _ = synthetic_sequence(case["frames"], size=case["size"],
                                       seed=case["seed"])
    engine = StereoSLAM(cam, device=dev, pg_mesh=mesh, seed=case["seed"],
                        **case["kwargs"])
    try:
        stats, s = _timed(dev, lambda: run_slam(engine, pairs))
    finally:
        engine.close()
    mine = {"positions": engine.vo.positions(),
            "keyframes": [ti for _, ti in engine.kf_history],
            "loops_closed": engine.loops_closed,
            "backend_errors": engine.backend_errors,
            "pg_costs": engine.last_pg_costs,
            "frame_ms_median": stats["frame_ms_median"]}
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, mine)
    return {"per_rank": per_rank}, s


RUNNERS = {"sad": _run_sad, "sgm": _run_sgm, "ba": _run_ba, "pg": _run_pg,
           "slam": _run_slam}


def run_cases(info, cases, out_path) -> None:
    """Rank function (``multihost.launch``): run each ``(name, case)`` of
    ``cases`` over the mesh of shape ``case.get("mesh", (1, world))``
    (built once per shape, in the list's order on every rank). A case is a
    dict with ``kind`` (a key of ``RUNNERS``), its numpy inputs and
    parameters, and optionally ``expect_error`` (a ValueError is then the
    result, as ``error``). Rank 0 writes ``{name: {outputs..., "ranks":
    [{launches, sent_bytes, seconds} of each rank]}}`` to ``out_path``
    (pickle); ``seconds`` is the rank's wall time of the sharded call."""
    from steroscopic_hardware_tpu_torch.parallel.mesh import make_mesh

    dev = info["device"]
    world = dist.get_world_size()
    meshes = {}
    results = {}
    for name, case in cases:
        shape = tuple(case.get("mesh", (1, world)))
        if shape not in meshes:
            meshes[shape] = make_mesh(n_batch=shape[0], n_rows=shape[1],
                                      device_type=dev.type)
        mesh = meshes[shape]
        _kernels.reset_launches()
        multihost.reset_sent_bytes()
        dist.barrier()
        seconds = None
        try:
            out, seconds = RUNNERS[case["kind"]](case, mesh, dev)
        except ValueError as e:
            if not case.get("expect_error"):
                raise
            out = {"error": f"{type(e).__name__}: {e}"}
        mine = {"launches": dict(_kernels.launches),
                "sent_bytes": dict(multihost.sent_bytes),
                "seconds": seconds}
        ranks = [None] * world
        dist.all_gather_object(ranks, mine)
        res = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
               for k, v in out.items()}
        res["ranks"] = ranks
        results[name] = res
    if dist.get_rank() == 0:
        with open(out_path, "wb") as f:
            pickle.dump(results, f)


def launch_cases(cases, world: int, *, backend: str, device) -> dict:
    """Run ``cases`` on ``world`` ranks (:func:`run_cases`) and return rank
    0's results."""
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/results.pkl"
        multihost.launch(run_cases, world, backend=backend, device=device,
                         args=(cases, path))
        with open(path, "rb") as f:
            return pickle.load(f)


# -- the dry run --------------------------------------------------------------

def _pair(rng, H, W, shift=4):
    left = rng.integers(0, 256, (H, W), dtype=np.uint8)
    right = np.clip(np.roll(left, -shift, axis=1).astype(int)
                    + rng.integers(-2, 3, (H, W)), 0, 255).astype(np.uint8)
    return left, right


def ba_problem(rng, M: int, N: int):
    """(xi0, points0, uv, mask, xi_true): N landmarks seen from M poses
    through ``BA_INTR``, both perturbed from the truth
    (``__graft_entry__``'s BA step, with the JAX test's
    perturbations)."""
    from steroscopic_hardware_tpu_torch.ops import se3_np

    intr = BA_INTR
    pts = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                    rng.uniform(4, 10, N)], -1).astype(np.float32)
    xi_true = np.zeros((M, 6), np.float32)
    for i in range(1, M):
        xi_true[i] = xi_true[i - 1] + np.concatenate(
            [rng.uniform(-0.1, 0.1, 3), rng.uniform(-0.02, 0.02, 3)])
    uv = np.zeros((M, N, 2), np.float32)
    for i in range(M):
        R, t = se3_np.se3_exp(xi_true[i])
        cam = pts @ R.T + t
        uv[i, :, 0] = intr[0] * cam[:, 0] / cam[:, 2] + intr[2]
        uv[i, :, 1] = intr[1] * cam[:, 1] / cam[:, 2] + intr[3]
    xi0 = xi_true + np.concatenate(
        [np.zeros((1, 6)), rng.normal(0, 0.04, (M - 1, 6))]).astype(
        np.float32)
    pts0 = pts + rng.normal(0, 0.08, pts.shape).astype(np.float32)
    return xi0, pts0, uv, np.ones((M, N), np.float32), xi_true


def loop_graph(rng, M: int):
    """(drifted nodes, edges, measurements, weights) of an M-node loop
    with chords; the truth a planar circle."""
    from steroscopic_hardware_tpu_torch.ops import se3_np

    step = np.array([0.4, 0, 0.1, 0, 2 * np.pi / M, 0], np.float32)
    truth = np.zeros((M, 6), np.float32)
    for i in range(1, M):
        truth[i] = se3_np.accum(step, truth[i - 1])
    edges = [(i, i + 1) for i in range(M - 1)]
    edges += [(M - 1, 0), (0, M // 2), (M // 4, 3 * M // 4)]
    meas = np.stack([se3_np.relative(truth[i], truth[j])
                     for i, j in edges]).astype(np.float32)
    nodes = truth + np.concatenate(
        [np.zeros((1, 6)), rng.normal(0, 0.05, (M - 1, 6))]).astype(
        np.float32)
    return (nodes, np.array(edges, np.int64), meas,
            np.ones(len(edges), np.float32))


def dryrun_cases(world: int, H: int, W: int):
    """The dry run's four cases at an (H, W) frame, drawn from seed 0."""
    rng = np.random.default_rng(0)
    left, right = _pair(rng, H, W)
    xi, pts, uv, mask, _ = ba_problem(rng, 3, 8 * world)
    nodes, edges, meas, w = loop_graph(rng, 6)
    return [
        ("sad", dict(kind="sad", left=left, right=right, block_size=5,
                     max_disparity=16)),
        ("sgm", dict(kind="sgm", left=left, right=right, max_disparity=16)),
        ("ba", dict(kind="ba", xi=xi, points=pts, uv=uv, mask=mask,
                    intr=BA_INTR, iters=4)),
        ("pg", dict(kind="pg", nodes=nodes, edges=edges, meas=meas, w=w,
                    iters=4)),
    ]


def single_rank(cases, device) -> dict:
    """Each dry-run case through the single-process functions on
    ``device``."""
    from steroscopic_hardware_tpu_torch.models.ba import BAProblem, ba_solve
    from steroscopic_hardware_tpu_torch.models.slam import (
        pose_graph_optimize,
    )
    from steroscopic_hardware_tpu_torch.ops.sad import disparity
    from steroscopic_hardware_tpu_torch.ops.sgm import sgm_disparity

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out = {}
    for name, c in cases:
        if c["kind"] == "sad":
            r = {"disp": disparity(t(c["left"]), t(c["right"]),
                                   block_size=c["block_size"],
                                   max_disparity=c["max_disparity"])}
        elif c["kind"] == "sgm":
            r = {"disp": sgm_disparity(
                t(c["left"]), t(c["right"]),
                max_disparity=c["max_disparity"],
                subpixel=c.get("subpixel", True), epilogue="fused")}
        elif c["kind"] == "ba":
            solved, errs = ba_solve(BAProblem(
                t(c["xi"]), t(c["points"]), t(c["uv"]), t(c["mask"]),
                tuple(c["intr"])), iters=c["iters"])
            r = {"xi": solved.xi, "points": solved.points, "errs": errs}
        else:
            xi, costs = pose_graph_optimize(
                t(c["nodes"]), t(c["edges"]), t(c["meas"]), t(c["w"]),
                iters=c["iters"])
            r = {"xi": xi, "costs": costs}
        out[name] = {k: v.cpu().numpy() for k, v in r.items()}
    return out


def compare(sharded: dict, single: dict) -> dict:
    """Per stage: shapes, bit-for-bit equality, the largest difference and
    (BA, pose graph) the JAX tests' tolerances: first error / cost within
    rtol 1e-5, poses within 5e-3 (BA) and 1e-4 (pose graph)."""
    out = {}
    for name, want in single.items():
        got = sharded[name]
        diff = max(float(np.abs(got[k].astype(np.float64)
                                - want[k].astype(np.float64)).max())
                   for k in want)
        stage = {"shapes": {k: list(got[k].shape) for k in want},
                 "equal": all(np.array_equal(got[k], want[k])
                              for k in want),
                 "max_abs_diff": diff}
        if "errs" in want or "costs" in want:
            curve = "errs" if "errs" in want else "costs"
            xi_tol = 5e-3 if curve == "errs" else 1e-4
            stage["within_tolerance"] = bool(
                np.allclose(got[curve][0], want[curve][0], rtol=1e-5)
                and np.allclose(got["xi"], want["xi"], atol=xi_tol))
        out[name] = stage
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="the sharded SAD, SGM, BA and pose graph once over a "
                    "mesh of ranks, against one rank")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None,
                    choices=multihost.BACKENDS,
                    help="default gloo on the CPU, nccl on cards (which "
                         "needs one card per rank)")
    ap.add_argument("--size", type=int, nargs=2, default=(64, 128),
                    metavar=("H", "W"))
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    H, W = args.size
    cases = dryrun_cases(args.world, H, W)
    sharded = launch_cases(cases, args.world, backend=backend,
                           device=args.device)
    single = single_rank(cases, multihost.rank_device(
        backend, args.device, 0, 1))
    stages = compare(sharded, single)
    ok = (stages["sad"]["equal"] and stages["sgm"]["equal"]
          and stages["ba"]["within_tolerance"]
          and stages["pg"]["within_tolerance"])
    device = (torch.cuda.get_device_name(0) if args.device == "cuda"
              else "cpu")
    print(json.dumps({"world": args.world, "backend": backend,
                      "device": device, "size": [H, W], "stages": stages,
                      "ok": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
