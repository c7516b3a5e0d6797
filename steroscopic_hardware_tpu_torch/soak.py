"""Long-run health check of live SLAM serving (the counterpart of
``tools/soak.py``): boots the server in its SLAM configuration as a
subprocess, samples its health surface on an interval for N minutes, and
writes the time series: memory (the server's RSS, and on the card its
device memory) that should stay flat, a bounded backend backlog, no
throughput decay, and the optimize time per loop closure.

    python -m steroscopic_hardware_tpu_torch.soak [--minutes 12] \\
        [--interval 10] [--json SOAK.json] [--size H W] [--device cpu]

The server is ``python -m steroscopic_hardware_tpu_torch --slam
--loop-closure`` (``--extra-args``) on a seeded textured pair
(``serve_probe.textured_pair``, 480x640 by default, as the JAX soak's
640x480 boot pair) re-published at 60 Hz, so the fused step tracks a
static rig, and every keyframe revisits the place of the ones before it.

Each sample records what the JAX soak records: wall clock, depth frames
and the depth fps in the window, SLAM frames and poses (every depth frame
is tracked by the fused step) and the pose rate in the window, keyframes,
loops closed, ``backend_pending``, ``loop_checks_skipped``,
``culled_keyframes``, ``fused_dropped``, the error counts, the cumulative
seconds per stage (the graph stage over the closures is the optimize time
per closure) and the server's RSS in MB from ``/proc/<pid>/status``. On
the card it adds the server's device memory, read from outside with
``nvidia-smi --query-compute-apps=pid,used_memory`` (``gpu_mem_mb``,
null where nvidia-smi lists no process of that pid, as in a container of
its own), and the card's used memory (``card_mem_used_mb``,
``--query-gpu=memory.used``). The server's standard error goes to a log
beside the JSON; the summary counts its tracebacks (a backend error
prints one). The server's ``/metrics`` and ``/slam`` are the JAX
server's: the soak adds nothing to them.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

SEED = 20261016  # the boot pair's texture


def fetch_json(base: str, path: str, timeout=10.0):
    with urllib.request.urlopen(base + path, timeout=timeout) as r:
        return json.loads(r.read())


def rss_mb(pid):
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024, 1)
    except OSError:
        pass
    return None


def _smi(*query) -> list[str]:
    proc = subprocess.run(["nvidia-smi", *query, "--format=csv,noheader,"
                           "nounits"], capture_output=True, text=True,
                          timeout=30)
    return [ln.strip() for ln in proc.stdout.splitlines() if ln.strip()]


def gpu_memory_mb(pid):
    """(the process's device memory, the card's used memory) in MiB from
    nvidia-smi; None where it lists no such process."""
    proc_mb = None
    for row in _smi("--query-compute-apps=pid,used_memory"):
        p, _, mb = row.partition(",")
        if p.strip() == str(pid):
            proc_mb = float(mb)
    used = _smi("--query-gpu=memory.used")
    return proc_mb, (float(used[0]) if used else None)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--minutes", type=float, default=12.0)
    ap.add_argument("--interval", type=float, default=10.0)
    ap.add_argument("--compile-wait", type=float, default=420.0,
                    help="seconds to wait for the kernel build, the first "
                         "frames and the SLAM backend's warmup")
    ap.add_argument("--json", default="SOAK.json")
    ap.add_argument("--extra-args", default="--slam,--loop-closure",
                    help="comma-separated extra server args")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640),
                    metavar=("H", "W"))
    args = ap.parse_args(argv)

    from steroscopic_hardware_tpu_torch.io.png import write_png
    from steroscopic_hardware_tpu_torch.serve_probe import textured_pair

    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("soak: --device cuda needs a usable GPU; "
                             "--device cpu runs the plain torch versions")
    extra = [a for a in args.extra_args.split(",") if a]
    with_slam = "--slam" in extra
    H, W = args.size
    out_dir = os.path.dirname(os.path.abspath(args.json))
    os.makedirs(out_dir, exist_ok=True)
    log_path = os.path.splitext(os.path.abspath(args.json))[0] + ".log"
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    samples = []
    with tempfile.TemporaryDirectory() as tmp, open(log_path, "w") as log:
        lp, rp = os.path.join(tmp, "left.png"), os.path.join(tmp, "right.png")
        for path, img in zip((lp, rp), textured_pair(SEED, H, W)):
            write_png(path, img)
        proc = subprocess.Popen(
            [sys.executable, "-m", "steroscopic_hardware_tpu_torch",
             "--port", str(port), "--no-open", "--fps", "60", "--left", lp,
             "--right", rp, "--device", args.device, "--cx", str(W / 2),
             "--cy", str(H / 2)] + extra,
            stdout=subprocess.DEVNULL, stderr=log)
        try:
            deadline = time.time() + args.compile_wait
            while True:
                if proc.poll() is not None:
                    raise SystemExit(f"soak: the server exited with "
                                     f"{proc.returncode}; see {log_path}")
                if time.time() > deadline:
                    raise SystemExit("soak: the server was not ready in "
                                     f"{args.compile_wait:.0f} s")
                try:
                    m = fetch_json(base, "/metrics")
                    s = fetch_json(base, "/slam") if with_slam else {}
                    if m["pipeline"]["frames"] >= 5 and (not with_slam or (
                            s.get("frames", 0) >= 2 and s.get("warm"))):
                        break
                except OSError:
                    pass
                time.sleep(0.2)

            t_start = time.time()
            last_frames = fetch_json(base, "/metrics")["pipeline"]["frames"]
            last_poses = (fetch_json(base, "/slam").get("positions_total", 0)
                          if with_slam else 0)
            last_t = t_start
            while time.time() - t_start < args.minutes * 60:
                time.sleep(args.interval)
                try:
                    m = fetch_json(base, "/metrics")["pipeline"]
                    s = fetch_json(base, "/slam") if with_slam else {}
                except OSError as e:
                    samples.append({"t": round(time.time() - t_start, 1),
                                    "error": str(e)})
                    continue
                now = time.time()
                frames = m.get("frames", 0)
                poses = s.get("positions_total", 0)
                loops = s.get("loops_closed", 0)
                graph_s = s.get("stage_s", {}).get("graph", 0.0)
                dt = max(now - last_t, 1e-6)
                gpu_mb, card_mb = (gpu_memory_mb(proc.pid)
                                   if args.device == "cuda" else (None, None))
                sample = {
                    "t": round(now - t_start, 1),
                    "depth_frames": frames,
                    "depth_fps_window": round((frames - last_frames) / dt, 2),
                    "slam_batches": s.get("frames"),
                    "slam_poses": poses,
                    "slam_pose_fps_window": round((poses - last_poses) / dt,
                                                  2),
                    "keyframes": s.get("keyframes"),
                    "loops_closed": loops,
                    "backend_pending": s.get("backend_pending"),
                    "loop_checks_skipped": s.get("loop_checks_skipped"),
                    "culled_keyframes": s.get("culled_keyframes"),
                    "fused_dropped": s.get("fused_dropped"),
                    "slam_errors": s.get("errors"),
                    "pipeline_errors": m.get("errors"),
                    "stage_s": s.get("stage_s"),
                    "ms_per_closure": (round(graph_s / loops * 1000, 1)
                                       if loops else None),
                    "rss_mb": rss_mb(proc.pid),
                    "gpu_mem_mb": gpu_mb,
                    "card_mem_used_mb": card_mb,
                }
                samples.append(sample)
                print(json.dumps(sample), flush=True)
                last_frames, last_poses, last_t = frames, poses, now
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    with open(log_path) as f:
        tracebacks = f.read().count("Traceback (most recent call last)")

    ok = [x for x in samples if "error" not in x]

    def span(key):
        vals = [x[key] for x in ok if x[key] is not None]
        return (min(vals), max(vals)) if vals else (None, None)

    rss, gpu = span("rss_mb"), span("gpu_mem_mb")
    summary = {
        "minutes": args.minutes,
        "device": args.device,
        "size": [H, W],
        "samples": len(samples),
        "sample_errors": len(samples) - len(ok),
        "server_tracebacks": tracebacks,
        "first": ok[0] if ok else None,
        "last": ok[-1] if ok else None,
        "rss_mb_min": rss[0],
        "rss_mb_max": rss[1],
        "gpu_mem_mb_min": gpu[0],
        "gpu_mem_mb_max": gpu[1],
        "backend_pending_max": span("backend_pending")[1],
        "log": log_path,
    }
    with open(args.json, "w") as f:
        json.dump({"summary": summary, "series": samples}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
