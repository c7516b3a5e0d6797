"""One run of one cell of the port's benchmark:

    python -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are found by name: ``BENCHMARK.json`` lists them,
``benchmark/configs/<config>.json`` holds the deployment,
``benchmark/traffic/<traffic>.json`` the generator's parameters, and
``benchmark/metrics/<metric>.py`` the reader of each metric.

The run builds the depth server as its users do
(``steroscopic_hardware_tpu_torch.__main__.build_app``), one pipeline per
rig, warms the serve step at every batch size the pipeline forms, and lets
the generators (``benchmark/scene.py``) publish pairs on the app's bus for
a short lead-in. Set-up ends when the measured window opens. In the window
every map published on a rig's ``out`` slot is stamped from a tap on the
bus's ``publish``; its latency runs from the moment its pair was due at the
generator. With ``--trace 1`` a fixed slice at the end of the window is
traced on the device (``benchmark/trace.py``; where the profiler recorded
no kernel or under half the slice, the traffic runs on and a further slice
is traced, up to six), and the host-side numbers are read over the part
of the window before it. After the window the app is
shut down, the device's peak memory read, the program's state freed, and
the maps judged (``benchmark/judge.py``) against the plain reference.

The last line on standard output is one JSON object: ``correct``,
``attempted`` (pairs the generators published in the window), ``failed``
(judged maps that were wrong, and maps that carried no id), ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, then ``run`` (counts and the
trace's own costs) and last ``checks``, each number compared beside its
limit; the checks are also the last lines on standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "steroscopic_hardware_tpu")
LEAD_IN_S = 2.0        # traffic before the window opens, part of set-up
TRACE_SLICE_S = 4.0    # the traced slice, at the end of the window
TRACE_ATTEMPTS = 6     # slices traced, one after another, until one is whole
HOLD_S = 4.0           # how long a generated pair's buffer stays unwritten
KEEP_SHARE = 0.25      # share of maps copied as candidates for the sample
KEEP_RGB_SHARE = 0.5   # share of colorized maps copied with their map
TOP = 10               # entries of each breakdown list


class RunFailed(RuntimeError):
    """A run that cannot print a result."""


def cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(root, "build")
    os.environ["STEROSCOPIC_KERNEL_DIR"] = os.path.join(build, "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_parts(spec: dict, name: str, bench_dir: str, root: str):
    """(cell, configuration, traffic) of the workload ``name``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise RunFailed(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = load_json(os.path.join(root, entry["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     cell["traffic"] + ".json"))
    return cell, config, traffic


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports."""
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load_reader(bench_dir: str, name: str):
    """``benchmark/metrics/<name>.py``, loaded by path (names hold dots)."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def _splitmix(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def keep_rule(seed: int, share: float, salt: int):
    """A seeded rule that picks a ``share`` of the (rig, frame id) keys."""
    base = _splitmix((seed % (1 << 64)) ^ _splitmix(salt))

    def keep(rig: int, frame_id: int) -> bool:
        h = _splitmix(base ^ (rig << 32) ^ frame_id)
        return (h >> 11) < share * (1 << 53)
    return keep


class Tap:
    """Wraps the bus's ``publish``: stamps every map published on a rig's
    out slot and reads the frame id it carries. From ``copy_from`` on it
    copies the maps ``keep`` picks and, where the pipeline publishes the
    colorized form of the newest map of its batch, that map and its RGB
    form where either was picked (``keep_rgb`` picks among these)."""

    def __init__(self, bus, out_slots, depth_slots, bands, keep, keep_rgb):
        from benchmark.judge import Served

        self._served = Served
        self._publish = bus.publish
        self.slots = {s: (i, "out") for i, s in enumerate(out_slots)}
        self.slots.update({s: (i, "depth") for i, s in enumerate(depth_slots)})
        self.bands, self.keep, self.keep_rgb = bands, keep, keep_rgb
        self.events: list = []      # (rig, frame id or None, time)
        self.kept: dict = {}        # (rig, frame id) -> (time, Served)
        self._last: dict = {}       # rig -> (frame id, map, time)
        self.copy_from = math.inf
        bus.publish = self.publish

    def publish(self, name, data, source=""):
        frame = self._publish(name, data, source)
        t = time.perf_counter()
        hit = self.slots.get(name)
        if hit is None:
            return frame
        rig, kind = hit
        if kind == "out":
            fid = self.bands[rig].decode(data)
            self.events.append((rig, fid, t))
            self._last[rig] = (fid, data, t)
            if (fid is not None and t >= self.copy_from
                    and (rig, fid) not in self.kept and self.keep(rig, fid)):
                self.kept[(rig, fid)] = (t, self._served(
                    rig, fid, np.array(data, copy=True), None))
            return frame
        fid, disp, t_out = self._last.pop(rig, (None, None, None))
        if fid is None or t_out < self.copy_from:
            return frame
        got = self.kept.get((rig, fid))
        if got is None and self.keep_rgb(rig, fid):
            got = self.kept[(rig, fid)] = (t_out, self._served(
                rig, fid, np.array(disp, copy=True), None))
        if got is not None and got[1].rgb is None:
            got[1].rgb = np.array(data, copy=True)
        return frame


@dataclasses.dataclass
class Run:
    """What the metric readers read (``benchmark/metrics/*.py``)."""
    config: dict
    traffic: dict
    setup_s: float = 0.0
    # (open, close) on time.perf_counter of what the host-side numbers
    # cover: the window, or in a traced run its part before the slice
    window: tuple = (0.0, 0.0)
    latencies_s: list = dataclasses.field(default_factory=list)
    served: int = 0                      # maps published in it
    offered: int = 0                     # pairs published in it
    gen_late_s: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)
    device_trace: object = None          # trace.TraceResult

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.5))


COUNTERS = ("frames", "batches", "dropped", "queue_dropped", "errors")


def whole(tr, span: float) -> bool:
    """A traced slice the profiler recorded: kernels in it, over at least
    half of its length."""
    kernels = any(not name.startswith(("Memcpy", "Memset"))
                  for name in tr.by_name)
    return kernels and tr.window_s >= span / 2


def counters(pipes) -> list:
    return [{k: getattr(p, k) for k in COUNTERS} for p in pipes]


def card_line() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool,
             *, device: str = "cuda", bench_dir: str = BENCH_DIR,
             root: str = ROOT, t_start: float = T_START) -> dict:
    """One run; returns the result line as a dict (see the module
    docstring). ``device="cpu"`` runs the program's plain versions, for
    the tests."""
    import torch

    from benchmark import judge
    from benchmark.scene import Generator, Scene
    from benchmark.trace import DeviceTrace
    from steroscopic_hardware_tpu_torch.__main__ import build_app
    from steroscopic_hardware_tpu_torch.utils.params import Parameters

    cell, config, traffic = cell_parts(spec, name, bench_dir, root)
    reference = judge.load_reference(root, config)
    dev = torch.device(device)
    params = config["params"]
    maxd = params["max_disparity"]
    rigs = int(traffic["rigs"])
    argv = [*config["server_args"], "--device", device, "--host",
            "127.0.0.1", "--port", "0", "--no-open"]
    for i in range(1, rigs):
        argv += ["--rig", f"rig{i + 1}"]
    app = build_app(argv)
    ctx = app.server.ctx
    pipes = [ctx.pipeline] + [ctx.rigs[f"rig{i + 1}"] for i in range(1, rigs)]
    for pipe in pipes:
        pipe.matcher.set_params(Parameters(params["block_size"], maxd))
    scenes = [Scene(height=config["height"], width=config["width"],
                    max_disparity=maxd, traffic=traffic, seed=seed, rig=i)
              for i in range(rigs)]
    rate = float(traffic["rate_hz"])
    gens = [Generator(ctx.bus, scenes[i], left_slot=p.left_slot,
                      right_slot=p.right_slot, rate_hz=rate,
                      phase_s=i / (rigs * rate),
                      hold_s=HOLD_S)
            for i, p in enumerate(pipes)]
    # the serve step at every batch size the pipeline forms, as it calls it
    for pipe, scene in zip(pipes, scenes):
        b = 1
        while b <= pipe.max_batch:
            pipe.matcher.compute_serve_async(
                [scene.pair(k) for k in range(b)], lr=pipe.lr_check,
                fetch_all=True, colorize_dev=False,
                rectifier=pipe.rectifier).result()
            b *= 2
    tap = Tap(ctx.bus, [p.out_slot for p in pipes],
              [p.depth_slot for p in pipes], [s.band for s in scenes],
              keep_rule(seed, KEEP_SHARE, 1),
              keep_rule(seed, KEEP_RGB_SHARE, 2))
    tracer, locks = None, []
    if trace:
        # the profiler starts with the program's launch locks held; a
        # start that races launches has left whole slices unrecorded
        locks = [getattr(p.matcher, "_launch_lock", None) for p in pipes]
        if any(lk is None for lk in locks):
            raise RunFailed("the matcher has no _launch_lock: the traced "
                            "slice cannot start between launches")
        tracer = DeviceTrace(dev)
        tracer.warm()
    run = Run(config=config, traffic=traffic)

    before = set(threading.enumerate())
    app.start()
    t0 = time.perf_counter() + 0.01
    for g in gens:
        g.start(t0)
    t_open = t0 + LEAD_IN_S
    t_close = t_open + seconds
    tap.copy_from = t_open
    sleep_until(t_open)
    run.setup_s = time.perf_counter() - t_start
    opened = counters(pipes)
    # a traced run traces the end of the window, so that the profiler's
    # stop comes after it; its host-side numbers are read before the slice
    t_host = t_close
    if tracer is not None:
        t_host = t_close - min(TRACE_SLICE_S, seconds / 2)
    sleep_until(t_host)
    closed = counters(pipes)
    rejected = []          # (events, recorded seconds) of slices not whole
    while tracer is not None and run.device_trace is None:
        # the first slice ends the window; where the profiler recorded no
        # kernel or under half of it, the traffic runs on and another
        # slice is traced
        if len(rejected) == TRACE_ATTEMPTS:
            raise RunFailed(f"{TRACE_ATTEMPTS} traced slices, none whole "
                            f"({rejected}): no device window")
        span = t_close - t_host
        tracer.start(locks)
        sleep_until(t_close if not rejected
                    else time.perf_counter() + span)
        tracer.stop()
        got = tracer.read()
        if whole(got, span):
            run.device_trace = got
        else:
            rejected.append((got.events, got.window_s))
    for g in gens:
        g.stop()
    app.shutdown()
    started = [t for t in threading.enumerate() if t not in before]
    for t in started:
        t.join(10.0)
    alive = [t.name for t in started if t.is_alive()]
    if alive:
        raise RunFailed(f"threads still running after shutdown: {alive}")
    run.window = (t_open, t_host)
    run.counters = {"open": opened, "close": closed}
    peak = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = int(torch.cuda.max_memory_allocated(dev))

    # what the window served
    last_k = [g.records[-1][0] if g.records else -1 for g in gens]
    seen = [set() for _ in range(rigs)]
    ids_bad = repeated = served = 0
    for rig, fid, t in tap.events:
        inside = t_open <= t < t_close
        if fid is None or fid > last_k[rig]:
            ids_bad += inside
            continue
        if fid in seen[rig]:
            # a map served again is no new map, and counts nowhere else
            repeated += inside
            continue
        seen[rig].add(fid)
        served += inside
        if t_open <= t < t_host:
            run.served += 1
            run.latencies_s.append(t - gens[rig].due(fid))
    for g in gens:
        for _, due, t in g.records:
            if t_open <= t < t_host:
                run.offered += 1
                run.gen_late_s.append(t - due)
    kept = {key: m for key, (t, m) in tap.kept.items() if t < t_close}
    gens_records = [g.records for g in gens]
    del app, ctx, pipes, gens, tap
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    sample = [kept[k] for k in judge.draw_sample(kept, rigs, seed)]
    compared = judge.compare(sample, scenes, reference, config, dev)
    ref_s = time.perf_counter() - t_ref
    empty = sum(int(not any(m.rig == r for m in sample))
                + int(not any(m.rig == r and m.rgb is not None
                              for m in sample))
                for r in range(rigs))
    checked = judge.checks({
        "map_px_wrong": compared["map_px_wrong"],
        "depth_px_wrong": compared["depth_px_wrong"],
        "ids_bad": ids_bad,
        "maps_repeated": repeated,
        "sample_empty": empty,
    })

    metrics = {}
    for entry in cell_metrics(spec, name, trace):
        value = load_reader(bench_dir, entry["name"]).read(run)
        if value is not None and math.isfinite(value):
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        else:
            print(f"metric {entry['name']}: nothing to read",
                  file=sys.stderr)
    out_device = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": int(cell["chips"]),
        "memory_peak_bytes": peak,
    }
    info = {
        "rigs": rigs, "served": served, "served_untraced": run.served,
        "offered_untraced": run.offered,
        "maps_compared": compared["maps_compared"],
        "depth_compared": compared["depth_compared"],
        "reference_s": ref_s,
        "card": card_line() if dev.type == "cuda" else None,
    }
    breakdown = None
    tr = run.device_trace
    if tr is not None:
        out_device["busy_s"] = tr.busy_s
        out_device["window_s"] = tr.window_s
        breakdown = {
            "device_ops": [[n[:160], s] for n, (s, _) in sorted(
                tr.by_name.items(), key=lambda kv: -kv[1][0])[:TOP]],
            "idle_gaps": [["after " + n[:154], s] for n, s in sorted(
                tr.gaps_after.items(), key=lambda kv: -kv[1])[:TOP]],
        }
        info.update(trace_rejected=rejected, trace_events=tr.events,
                    trace_markers=tr.markers,
                    trace_stop_s=tracer.stop_s,
                    trace_post_s=tr.post_s)
    info["host_rss_peak_bytes"] = (
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    from benchmark.schema import result_line

    return result_line(
        correct=judge.within(checked),
        attempted=sum(t_open <= t < t_close
                      for g in gens_records for _, _, t in g),
        failed=compared["maps_wrong"] + ids_bad,
        metrics=metrics, device=out_device, trace=trace,
        breakdown=breakdown, info=info, checks=checked)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}.get(
        args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    cache_dirs(ROOT)
    line = run_cell(spec, args.workload, args.seed, args.seconds,
                    bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for check, c in line["checks"].items():
        print(f"check {check} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException:  # no result: say why, and leave no thread behind
        import traceback

        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
