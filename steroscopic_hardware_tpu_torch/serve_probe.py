"""Serving probe: boots the live depth server in-process
(``__main__.build_app``) once per serving mode on a seeded textured stereo
pair and reads ``/metrics`` over a steady window (the counterpart of
``tools/serve_bench.py``).

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

``device-colorize-preview-2`` is serve_bench's ``sad-dev-light2``:
``--device-colorize --preview-scale 2``, the colorized preview made and
downscaled on the device.

The modes of ``tools/serve_bench.py`` beyond the static-source ones:

* ``slam`` / ``slam-sgm`` / ``slam-sgm-half``: ``--slam --loop-closure``
  (the fused serve+track step; ``--backend sgm`` serves SGM depth beside
  the SAD front end's tracking; ``--slam-frontend sgm_half`` tracks on
  half-resolution census + SGM disparities, serve_bench's ``slam-1080p``
  at the default 1080p), with ``--cx`` / ``--cy`` at the frame centre.
  The window opens once ``/slam`` reads ``warm``; the row adds SLAM
  frames and poses per second and the backend's queue.
* ``dual-rig``: a second rig (``--rig rig2``) on a second seeded pair,
  both rigs' fps in one window. Both pipelines enqueue on the card's one
  current stream, so each rig's ``device_s`` spans the other's work too:
  the two busy shares may sum to more than 1.
* ``tcp-raw`` / ``tcp-range`` / ``tcp-lzma``: no static sources; two
  ``CameraEmitter``s stream the pair at ``--fps`` in codec 0 / 1 / 2 and
  are attached through ``POST /left/configure`` and ``/right/configure``.
  The row adds the wire bytes per frame and the frame parser the sources
  used (the native C++ one, or the Python one where it did not build).
  SGM over TCP is ``chip_smoke.py`` phase 10g's, which prints its served
  fps and source rates.

Every row gives each source's frames per second in the window
(``source_rates``; ``source_fps`` is the rate asked of them), so a served
rate below the cameras' shows.

``serve_bench``'s tunnel-bandwidth probe is left out: it measured the
transport between a host and a remote TPU, which a card in the host does
not have.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
import urllib.request

import numpy as np

from steroscopic_hardware_tpu_torch.io.png import write_png
from steroscopic_hardware_tpu_torch.runtime import wire
from steroscopic_hardware_tpu_torch.utils.device import card_name

# mode name -> (extra server flags, source fps multiplier)
MODES = {
    "default": ([], 1),
    "device-colorize": (["--device-colorize"], 1),
    "preview-scale-2": (["--preview-scale", "2"], 1),
    "device-colorize-preview-2": (["--device-colorize", "--preview-scale",
                                   "2"], 1),
    "lr-check": (["--lr-check"], 1),
    "sources-2x": ([], 2),
    "sgm": (["--backend", "sgm"], 1),
    "sgm-lr-check": (["--backend", "sgm", "--lr-check"], 1),
    "slam": (["--slam", "--loop-closure"], 1),
    "slam-sgm": (["--slam", "--loop-closure", "--backend", "sgm"], 1),
    "slam-sgm-half": (["--slam", "--loop-closure", "--slam-frontend",
                       "sgm_half"], 1),
    "dual-rig": ([], 1),
    "tcp-raw": ([], 1),
    "tcp-range": ([], 1),
    "tcp-lzma": ([], 1),
}
TCP_CODECS = {"tcp-raw": wire.CODEC_RAW, "tcp-range": wire.CODEC_RANGE,
              "tcp-lzma": wire.CODEC_LZMA}
RIG = "rig2"
_LAT = ("queue", "serve", "host")


def _get_json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.load(r)


def _metrics(base: str) -> dict:
    return _get_json(base + "/metrics")["pipeline"]


def textured_pair(seed: int, height: int, width: int, shift: int = 24):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (height, width), dtype=np.uint8)
    right = np.clip(np.roll(left, -shift, axis=1).astype(int)
                    + rng.integers(-2, 3, (height, width)), 0,
                    255).astype(np.uint8)
    return left, right


def configure(base: str, slot: str, form: dict) -> dict:
    """``POST /<slot>/configure`` with ``form`` (host / port, or device /
    baud); returns the server's JSON answer."""
    body = "&".join(f"{k}={v}" for k, v in form.items()).encode()
    req = urllib.request.Request(
        f"{base}/{slot}/configure", data=body, method="POST",
        headers={"Content-Type": "application/x-www-form-urlencoded"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.load(r)


def attach_emitters(base: str, frames: dict, codec: int, fps: float):
    """Start one ``CameraEmitter`` per slot of ``frames`` (slot -> a frame,
    or a function of the frame index) and attach each through
    ``POST /<slot>/configure``. Returns the started emitters (the caller
    closes them)."""
    from steroscopic_hardware_tpu_torch.runtime.emitter import CameraEmitter

    emitters = []
    try:
        for slot, frame in frames.items():
            fn = frame if callable(frame) else (lambda n, f=frame: f)
            em = CameraEmitter(fn, codec=codec, fps=fps).start()
            emitters.append(em)
            configure(base, slot, {"host": "127.0.0.1", "port": em.port})
    except Exception:
        for em in emitters:
            em.close()
        raise
    return emitters


def probe_mode(argv, seconds: float, warm_frames: int = 10,
               timeout: float = 120.0, feed=None, slam: bool = False,
               rig: str | None = None) -> dict:
    """Serve with ``argv``, run ``feed(base)`` (which attaches sources and
    returns what to close), skip ``warm_frames`` frames (the kernel build
    and first launches) and, with ``slam``, wait for the backend warmup,
    then read /metrics ``seconds`` apart."""
    from steroscopic_hardware_tpu_torch.__main__ import build_app

    app = build_app(argv).start()
    feeders = []
    try:
        base = app.url
        if feed is not None:
            feeders = feed(base)
        t_start = time.time()
        while _metrics(base)["frames"] < warm_frames or (
                slam and not _get_json(base + "/slam").get("warm")):
            if time.time() - t_start > timeout:
                raise RuntimeError(f"no {warm_frames} frames (and warm SLAM)"
                                   f" in {timeout} s")
            time.sleep(0.05)
        s0 = _get_json(base + "/slam") if slam else None
        m0, t0 = _get_json(base + "/metrics"), time.time()
        time.sleep(seconds)
        m1, t1 = _get_json(base + "/metrics"), time.time()
        s1 = _get_json(base + "/slam") if slam else None
        parsers = sorted({type(s.parser).__name__ for s in
                          app.manager._sources.values()
                          if getattr(s, "parser", None) is not None})
    finally:
        app.shutdown()
        for f in feeders:
            f.close()
    wall = t1 - t0
    p0, p1 = m0["pipeline"], m1["pipeline"]
    row = {
        "frames": p1["frames"] - p0["frames"],
        "batches": p1["batches"] - p0["batches"],
        "window_s": wall,
        "fps": (p1["frames"] - p0["frames"]) / wall,
        "metrics_fps": p1.get("fps"),
        "errors": p1["errors"],
    }
    for name in _LAT:
        row[f"lat_{name}_p50"] = p1.get(f"lat_{name}_p50")
        row[f"lat_{name}_p95"] = p1.get(f"lat_{name}_p95")
    if p1["device_s"] is not None:
        row["device_busy"] = (p1["device_s"] - p0["device_s"]) / wall
    row["source_rates"] = {
        slot: (m1["sources"][slot]["frames"]
               - m0["sources"][slot]["frames"]) / wall
        for slot in m1["sources"]}
    if parsers:
        row["parsers"] = parsers
    if rig is not None:
        r0, r1 = m0["rigs"][rig], m1["rigs"][rig]
        row[f"{rig}_frames"] = r1["frames"] - r0["frames"]
        row[f"{rig}_fps"] = row[f"{rig}_frames"] / wall
        row[f"{rig}_errors"] = r1["errors"]
        row["both_rigs_fps"] = row["fps"] + row[f"{rig}_fps"]
        if r1["device_s"] is not None:
            row[f"{rig}_device_busy"] = (r1["device_s"] - r0["device_s"]) / wall
    if slam:
        row["slam_frames_per_s"] = (s1["frames"] - s0["frames"]) / wall
        row["slam_pose_fps"] = (s1["positions_total"]
                                - s0["positions_total"]) / wall
        row["slam_keyframes"] = s1["keyframes"]
        row["slam_loops_closed_window"] = (s1["loops_closed"]
                                           - s0["loops_closed"])
        row["slam_backend_pending"] = s1["backend_pending"]
        row["slam_fused_dropped"] = s1["fused_dropped"]
        row["slam_errors"] = s1["errors"]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--fps", type=float, default=60.0,
                    help="rate of each static source or emitter")
    ap.add_argument("--seconds", type=float, default=7.0,
                    help="length of the measured window per mode")
    ap.add_argument("--modes", default=",".join(MODES),
                    help=f"comma-separated subset of {', '.join(MODES)}")
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--out", default=None, help="also write the rows here")
    args = ap.parse_args(argv)

    card = card_name(args.device)
    print(f"device: {card}", flush=True)
    rows = []
    h, w = args.height, args.width
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"{n}.png") for n in ("l", "r", "l2", "r2")]
        left, right = textured_pair(args.seed, h, w)
        pairs = ((left, right), textured_pair(args.seed + 1, h, w, shift=16))
        for path, img in zip(paths, [a for p in pairs for a in p]):
            write_png(path, img)
        for mode in args.modes.split(","):
            flags, rate = MODES[mode]
            fps = args.fps * rate
            argv_mode = ["--no-open", "--port", "0", "--device", args.device,
                         "--fps", str(fps), *flags]
            kw = {}
            row = {"mode": mode, "source_fps": fps, "shape": [h, w],
                   "device": card}
            if mode in TCP_CODECS:
                codec = TCP_CODECS[mode]
                kw["feed"] = lambda base, c=codec: attach_emitters(
                    base, {"left": left, "right": right}, c, fps)
                row["codec"] = codec
                row["wire_bytes_per_frame"] = len(wire.encode_frame(left,
                                                                    codec))
            else:
                argv_mode += ["--left", paths[0], "--right", paths[1]]
            if mode == "dual-rig":
                argv_mode += ["--rig", f"{RIG}={paths[2]},{paths[3]}"]
                kw["rig"] = RIG
            if mode.startswith("slam"):
                argv_mode += ["--cx", str(w / 2), "--cy", str(h / 2)]
                kw["slam"] = True
            row.update(probe_mode(argv_mode, args.seconds, **kw))
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
