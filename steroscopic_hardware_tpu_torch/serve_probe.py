"""Serving probe: boots the live depth server in-process
(``__main__.build_app``) once per serving mode on a seeded textured stereo
pair and reads ``/metrics`` over a steady window.

    python -m steroscopic_hardware_tpu_torch.serve_probe     # 1080p, cuda
    python -m steroscopic_hardware_tpu_torch.serve_probe --device cpu \
        --height 48 --width 160 --seconds 1 --modes default

The first line names the device (on CUDA: ``nvidia-smi`` name and power
limit). Then one JSON line per mode: frames and batches published in the
window, ``fps`` (frames over the window's wall time), the pipeline's rolling
``metrics_fps``, queue / serve / host latency p50 / p95 in ms as ``/metrics``
gives them (over the last 100 frames), and on CUDA ``device_busy``: the
growth of the pipeline's ``device_s`` (CUDA events around each serve step)
over the window's wall time, so the device idles ``1 - device_busy`` of it.
With ``--out`` the rows are also written there as a JSON list.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
import urllib.request

import numpy as np

from steroscopic_hardware_tpu_torch.io.png import write_png

# mode name -> (extra server flags, source fps multiplier)
MODES = {
    "default": ([], 1),
    "device-colorize": (["--device-colorize"], 1),
    "preview-scale-2": (["--preview-scale", "2"], 1),
    "lr-check": (["--lr-check"], 1),
    "sources-2x": ([], 2),
    "sgm": (["--backend", "sgm"], 1),
    "sgm-lr-check": (["--backend", "sgm", "--lr-check"], 1),
}
_LAT = ("queue", "serve", "host")


def _metrics(base: str) -> dict:
    with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
        return json.load(r)["pipeline"]


def textured_pair(seed: int, height: int, width: int, shift: int = 24):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (height, width), dtype=np.uint8)
    right = np.clip(np.roll(left, -shift, axis=1).astype(int)
                    + rng.integers(-2, 3, (height, width)), 0,
                    255).astype(np.uint8)
    return left, right


def probe_mode(argv, seconds: float, warm_frames: int = 10,
               timeout: float = 120.0) -> dict:
    """Serve with ``argv``, skip ``warm_frames`` frames (the kernel build
    and first launches), then read /metrics ``seconds`` apart."""
    from steroscopic_hardware_tpu_torch.__main__ import build_app

    app = build_app(argv).start()
    try:
        base = app.url
        t_start = time.time()
        while _metrics(base)["frames"] < warm_frames:
            if time.time() - t_start > timeout:
                raise RuntimeError(f"no {warm_frames} frames in {timeout} s")
            time.sleep(0.05)
        m0, t0 = _metrics(base), time.time()
        time.sleep(seconds)
        m1, t1 = _metrics(base), time.time()
    finally:
        app.shutdown()
    wall = t1 - t0
    row = {
        "frames": m1["frames"] - m0["frames"],
        "batches": m1["batches"] - m0["batches"],
        "window_s": wall,
        "fps": (m1["frames"] - m0["frames"]) / wall,
        "metrics_fps": m1["fps"],
        "errors": m1["errors"],
    }
    for name in _LAT:
        row[f"lat_{name}_p50"] = m1.get(f"lat_{name}_p50")
        row[f"lat_{name}_p95"] = m1.get(f"lat_{name}_p95")
    if m1["device_s"] is not None:
        row["device_busy"] = (m1["device_s"] - m0["device_s"]) / wall
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--fps", type=float, default=60.0,
                    help="rate of each static source")
    ap.add_argument("--seconds", type=float, default=7.0,
                    help="length of the measured window per mode")
    ap.add_argument("--modes", default=",".join(MODES),
                    help=f"comma-separated subset of {', '.join(MODES)}")
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--out", default=None, help="also write the rows here")
    args = ap.parse_args(argv)

    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.splitlines()[0]
    else:
        card = "cpu"
    print(f"device: {card}", flush=True)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        lp, rp = os.path.join(tmp, "l.png"), os.path.join(tmp, "r.png")
        left, right = textured_pair(args.seed, args.height, args.width)
        write_png(lp, left)
        write_png(rp, right)
        for mode in args.modes.split(","):
            flags, rate = MODES[mode]
            argv_mode = ["--left", lp, "--right", rp, "--no-open",
                         "--port", "0", "--device", args.device,
                         "--fps", str(args.fps * rate), *flags]
            row = {"mode": mode, "source_fps": args.fps * rate,
                   "shape": [args.height, args.width], "device": card,
                   **probe_mode(argv_mode, args.seconds)}
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
