"""Application entry point: ``python -m steroscopic_hardware_tpu_torch``
(counterpart of ``steroscopic_hardware_tpu/__main__.py``).

Same flags as the JAX server, plus ``--device {cuda,cpu}`` (default cuda:
the hand-written kernels, raising at start without a usable GPU; cpu runs
the plain torch versions). ``--backend sgm`` serves the census/SGM engine
(``SGMMatcher``) instead of SAD. ``--slam`` adds live stereo SLAM
(``SlamPipeline``; the fused serve+track step unless ``--no-slam-fused``),
its trajectory at ``GET /slam`` and ``GET /slam/trajectory`` and on the
live page. ``--calib rig.json`` serves raw (unrectified, distorted)
cameras: the calibration's maps live on ``--device`` and every served
batch is rectified there after its one upload; with ``--slam`` the
rectified rig supplies the camera (``K_new`` and the baseline).
``--backend xla`` exits with an error: there is no XLA here.

``build_app`` builds the whole server (matcher, pipelines, sources, HTTP
server bound to its port) without serving; ``run`` serves it until SIGINT /
SIGTERM, then shuts down. Scripts drive the same code in-process through
``build_app(argv).start()``.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading

from steroscopic_hardware_tpu_torch.runtime import logger as shlog
from steroscopic_hardware_tpu_torch.runtime.manager import CameraManager
from steroscopic_hardware_tpu_torch.models.blockmatch import (
    BlockMatcher,
    SGMMatcher,
)
from steroscopic_hardware_tpu_torch.runtime.pipeline import (
    DepthPipeline,
    SlamPipeline,
)
from steroscopic_hardware_tpu_torch.runtime.server import AppContext, Server
from steroscopic_hardware_tpu_torch.runtime.sources import (
    SerialSource,
    StaticSource,
)

def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="stereo depth server (PyTorch + CUDA)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--left", default=None, help="left boot image (PNG)")
    ap.add_argument("--right", default=None, help="right boot image (PNG)")
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--lr-check", action="store_true")
    ap.add_argument("--no-open", dest="open_browser", action="store_false",
                    default=True,
                    help="do not auto-open the live view in a browser")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the hand-written kernels (fails at start "
                         "without a usable GPU); cpu: the plain torch "
                         "versions")
    ap.add_argument(
        "--backend", default="auto", choices=["auto", "pallas", "xla", "sgm"],
        help="auto/pallas: the SAD kernels; sgm: the census/SGM engine; "
             "xla is not available in this package",
    )
    ap.add_argument("--slam", action="store_true",
                    help="run live stereo SLAM; trajectory at GET /slam")
    ap.add_argument("--slam-frontend", default="sad",
                    choices=["sad", "sgm", "sgm_half"],
                    help="SLAM tracking front end: sad (fastest), sgm "
                         "(census quality), sgm_half (census at half "
                         "resolution)")
    ap.add_argument("--no-slam-fused", dest="slam_fused",
                    action="store_false", default=True,
                    help="track on the SLAM pipeline's own thread (its own "
                         "upload of the newest pair) instead of inside the "
                         "serve step")
    ap.add_argument("--calib", default=None,
                    help="stereo calibration JSON (io/calib.py): rectify "
                         "raw cameras on the device before matching")
    ap.add_argument("--fx", type=float, default=500.0)
    ap.add_argument("--fy", type=float, default=500.0)
    ap.add_argument("--cx", type=float, default=None)
    ap.add_argument("--cy", type=float, default=None)
    ap.add_argument("--baseline", type=float, default=0.1,
                    help="stereo baseline in meters")
    ap.add_argument("--slam-checkpoint-dir", default=None,
                    help="persist / resume SLAM state here")
    ap.add_argument("--loop-closure", action="store_true",
                    help="enable SLAM loop closure (BoW place recognition "
                         "+ pose-graph re-optimization)")
    ap.add_argument("--pg-horizon", type=int, default=None,
                    help="fixed-lag pose graph: each closure optimizes only "
                         "the newest N keyframe poses (older ones frozen); "
                         "default: the whole graph")
    ap.add_argument("--auth-token", default=os.environ.get("SHTPU_TOKEN"),
                    help="require this bearer token on every endpoint "
                         "except /checkhealth (header 'Authorization: "
                         "Bearer <t>' or ?token=<t>); defaults to "
                         "$SHTPU_TOKEN")
    ap.add_argument("--tls-cert", default=None,
                    help="serve HTTPS with this PEM certificate chain")
    ap.add_argument("--tls-key", default=None,
                    help="PEM private key for --tls-cert")
    ap.add_argument("--rig", action="append", default=[],
                    metavar="NAME[=LEFT.png,RIGHT.png]",
                    help="serve an extra stereo rig (repeatable): slots "
                         "NAME.left/NAME.right -> NAME.out/NAME.depth, "
                         "own pipeline + parameters (update-params with "
                         "rig=NAME); optional boot images")
    ap.add_argument("--max-stream-clients", type=int, default=32,
                    help="cap on concurrent /mjpeg push streams "
                         "(503 beyond)")
    ap.add_argument("--preview-scale", type=int, default=1,
                    help="downscale the depth preview k x k and fetch only "
                         "the newest depth per batch")
    ap.add_argument("--device-colorize", dest="host_colorize",
                    action="store_false", default=True,
                    help="colorize the preview on the device and fetch RGB "
                         "(default: fetch uint8 depth only and colorize "
                         "host-side via the Turbo LUT)")
    ap.add_argument("--serial", action="append", default=[],
                    metavar="SLOT=DEVICE[@BAUD]",
                    help="attach a real serial camera (repeatable), e.g. "
                         "--serial left=/dev/ttyUSB0@921600")
    ap.add_argument("--dedup-uploads", action="store_true",
                    help="skip byte-identical consecutive stereo pairs "
                         "before upload (paused/static feeds)")
    ap.add_argument("--prewarm", action="store_true",
                    help="build the kernels and launch once in the "
                         "background at startup")
    args = ap.parse_args(argv)
    if args.backend == "xla":
        ap.error("--backend xla: there is no plain path on the GPU; "
                 "--device cpu runs the plain torch versions")
    return args


class App:
    """A built server: matcher, pipelines, sources and the HTTP server
    (bound, not yet serving)."""

    def __init__(self, args, manager, matcher, server, log,
                 slam_pipeline=None, rectifier=None):
        self.args = args
        self.manager = manager
        self.matcher = matcher
        self.server = server
        self.log = log
        self.slam_pipeline = slam_pipeline
        self.rectifier = rectifier

    @property
    def url(self) -> str:
        scheme = "https" if self.server.tls else "http"
        return f"{scheme}://{self.args.host}:{self.server.port}"

    def start(self) -> "App":
        self.server.start()
        if self.args.prewarm and hasattr(self.matcher, "warmup"):
            # the matcher sees rectified frames: warm the calibration's
            # size (the JAX server warms the raw frames' shape)
            lf = self.manager.bus.latest("left")
            if self.rectifier is not None:
                shape = self.rectifier.size
            else:
                shape = lf.data.shape if lf is not None else (480, 640)
            p = self.matcher.get_params()
            threading.Thread(
                target=lambda: self.matcher.warmup(
                    shape, [p], lr=self.args.lr_check),
                daemon=True,
            ).start()
            self.log.info("prewarming %s for shape %s", p.to_json(), shape)
        return self

    def shutdown(self) -> None:
        self.server.shutdown()


def build_app(argv=None) -> App:
    args = parse_args(argv)
    log = shlog.get_logger("main")
    manager = CameraManager()
    rectifier = None
    if args.calib:
        from steroscopic_hardware_tpu_torch.io.calib import load_calibration

        # raises here on --device cuda without a GPU
        rectifier = load_calibration(args.calib, device=args.device)
        log.info("calibrated rig: rectifying to %s, baseline %.4f m",
                 rectifier.K_new[:2, 2], rectifier.baseline)

    def make_matcher():
        if args.backend == "sgm":
            return SGMMatcher(device=args.device)
        return BlockMatcher(device=args.device)

    matcher = make_matcher()  # raises here on --device cuda without a GPU
    slam_pipeline = None
    if args.slam:
        from steroscopic_hardware_tpu_torch.models.slam import StereoCamera

        if rectifier is not None:
            # the rectified rig defines the intrinsics: shared K_new,
            # pure-horizontal baseline
            K = rectifier.K_new
            cam = StereoCamera(fx=float(K[0, 0]), fy=float(K[1, 1]),
                               cx=float(K[0, 2]), cy=float(K[1, 2]),
                               baseline=rectifier.baseline)
        else:
            cam = StereoCamera(
                fx=args.fx, fy=args.fy,
                cx=args.cx if args.cx is not None else 320.0,
                cy=args.cy if args.cy is not None else 240.0,
                baseline=args.baseline)
        slam_pipeline = SlamPipeline(
            manager.bus, cam, checkpoint_dir=args.slam_checkpoint_dir,
            rectifier=rectifier,
            slam_kwargs={"loop_closure": args.loop_closure,
                         "frontend": args.slam_frontend,
                         "pg_horizon": args.pg_horizon,
                         "device": args.device})
    # fused serve+track (the default with --slam): the serve step tracks
    # every frame of its batch, one upload and one copy back for both
    pipeline = DepthPipeline(manager.bus, matcher, lr_check=args.lr_check,
                             rectifier=rectifier,
                             preview_scale=args.preview_scale,
                             host_colorize=args.host_colorize,
                             dedup_uploads=args.dedup_uploads,
                             slam_pipeline=slam_pipeline,
                             fuse_slam=args.slam_fused)

    rigs = {}
    for spec in args.rig:
        name, _, boot = spec.partition("=")
        if not name or "." in name:
            raise SystemExit(f"bad --rig name {name!r}")
        rigs[name] = DepthPipeline(
            manager.bus, make_matcher(), lr_check=args.lr_check,
            rectifier=rectifier, preview_scale=args.preview_scale,
            host_colorize=args.host_colorize,
            dedup_uploads=args.dedup_uploads,
            left_slot=f"{name}.left", right_slot=f"{name}.right",
            out_slot=f"{name}.out", depth_slot=f"{name}.depth",
        )
        if boot:
            lpath, _, rpath = boot.partition(",")
            manager.set_source(f"{name}.left", StaticSource(
                manager.bus, f"{name}.left", lpath, fps=args.fps))
            manager.set_source(f"{name}.right", StaticSource(
                manager.bus, f"{name}.right", rpath, fps=args.fps))

    ctx = AppContext(pipeline, manager=manager,
                     auth_token=args.auth_token,
                     max_stream_clients=args.max_stream_clients,
                     rigs=rigs, slam_pipeline=slam_pipeline)

    serial_slots = set()
    for spec in args.serial:
        slot, _, dev = spec.partition("=")
        dev, _, baud = dev.partition("@")
        if not slot or not dev:
            raise SystemExit(f"bad --serial spec {spec!r}")
        manager.set_source(slot, SerialSource(
            manager.bus, slot, dev, baud=int(baud or 921600)))
        serial_slots.add(slot)

    if serial_slots >= {"left", "right"}:
        pass  # both live cameras attached; no static boot sources
    elif (args.left and args.right and os.path.exists(args.left)
            and os.path.exists(args.right)):
        for side, path in (("left", args.left), ("right", args.right)):
            if side not in serial_slots:
                manager.set_source(side, StaticSource(
                    manager.bus, side, path, fps=args.fps))
    else:
        log.warning("boot images missing; configure cameras via the API")

    server = Server(ctx, host=args.host, port=args.port,
                    tls_cert=args.tls_cert, tls_key=args.tls_key)
    return App(args, manager, matcher, server, log, slam_pipeline,
               rectifier)


def run(argv=None) -> None:
    app = build_app(argv).start()
    url = app.url + "/live"
    app.log.info("live view: %s", url)
    if app.args.open_browser:
        # best-effort, silent on headless hosts
        def _open():
            import webbrowser

            try:
                webbrowser.open(url)
            except Exception:
                pass

        threading.Thread(target=_open, daemon=True).start()

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        app.log.info("shutting down")
        app.shutdown()


main = run

if __name__ == "__main__":
    main()
