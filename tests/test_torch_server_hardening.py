"""The port's serving hardening on the CPU, as
``tests/test_server_hardening.py`` holds the JAX server: the bearer token,
TLS, the MJPEG client cap, the shared PNG encode cache and multi-rig
routing; then the flags that build them, each through
``__main__.build_app``: ``--auth-token``, ``--tls-cert`` / ``--tls-key``,
``--max-stream-clients``, ``--rig``, ``--serial`` and ``--dedup-uploads``.

``--dedup-uploads`` never reaches a ``--rig`` pipeline in the JAX
``__main__.py`` (the flag goes to the default rig's pipeline only); the
port passes it to every rig, and
``test_dedup_uploads_reaches_every_rig`` holds that.
"""

import json
import ssl
import subprocess
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu_torch.__main__ import build_app
from steroscopic_hardware_tpu_torch.io.png import write_png
from steroscopic_hardware_tpu_torch.models.blockmatch import BlockMatcher
from steroscopic_hardware_tpu_torch.runtime.manager import CameraManager
from steroscopic_hardware_tpu_torch.runtime.pipeline import DepthPipeline
from steroscopic_hardware_tpu_torch.runtime.server import (
    AppContext,
    Server,
    split_slot,
)
from steroscopic_hardware_tpu_torch.runtime.sources import (
    SerialSource,
    StaticSource,
    SyntheticSource,
)
from steroscopic_hardware_tpu_torch.utils.params import ParamValidationError

from torch_wait import wait


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # six test workers share the machine's cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mgr():
    mgr = CameraManager()
    mgr.set_source("left", SyntheticSource(
        mgr.bus, "left", shape=(24, 48), fps=50.0, seed=3))
    mgr.set_source("right", SyntheticSource(
        mgr.bus, "right", shape=(24, 48), fps=50.0, shift=3, seed=3))
    return mgr


def _matcher():
    return BlockMatcher(device="cpu")


def _server(**ctx_kwargs):
    mgr = _mgr()
    pipe = DepthPipeline(mgr.bus, _matcher())
    return Server(AppContext(pipe, manager=mgr, **ctx_kwargs))


def _request(url, data=None, timeout=5.0, headers=None, sslctx=None):
    req = urllib.request.Request(url, data=data, headers=headers or {})
    if data is not None:
        req.add_header("Content-Type", "application/x-www-form-urlencoded")
    try:
        with urllib.request.urlopen(req, timeout=timeout,
                                    context=sslctx) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _self_signed(tmp_path):
    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    p = subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout",
         str(key), "-out", str(cert), "-days", "1", "-nodes", "-subj",
         "/CN=localhost"], capture_output=True)
    assert p.returncode == 0, p.stderr[-1000:]
    return str(cert), str(key)


def _insecure():
    sctx = ssl.create_default_context()
    sctx.check_hostname = False
    sctx.verify_mode = ssl.CERT_NONE
    return sctx


def test_auth_token_enforced():
    srv = _server(auth_token="sekrit").start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        # liveness stays open
        assert _request(base + "/checkhealth")[0] == 200
        # everything else requires the token
        assert _request(base + "/metrics")[0] == 401
        assert _request(base + "/live")[0] == 401
        code, body = _request(base + "/metrics",
                              headers={"Authorization": "Bearer sekrit"})
        assert code == 200 and b"pipeline" in body
        # query-param form (for <img> tags that cannot set headers)
        assert _request(base + "/metrics?token=sekrit")[0] == 200
        assert _request(base + "/metrics?token=wrong")[0] == 401
        # POST is guarded too
        assert _request(base + "/update-params",
                        data=b"blockSize=7&maxDisparity=64")[0] == 401
        assert srv.ctx.pipeline.matcher.get_params().block_size == 16
    finally:
        srv.shutdown()


def test_tls_serving(tmp_path):
    cert, key = _self_signed(tmp_path)
    mgr = _mgr()
    pipe = DepthPipeline(mgr.bus, _matcher())
    srv = Server(AppContext(pipe, manager=mgr), tls_cert=cert,
                 tls_key=key).start()
    try:
        code, body = _request(f"https://127.0.0.1:{srv.port}/checkhealth",
                              sslctx=_insecure())
        assert code == 200 and body == b"OK"
        assert srv.tls
    finally:
        srv.shutdown()


def test_mjpeg_client_cap():
    srv = _server(max_stream_clients=2).start()
    base = f"http://127.0.0.1:{srv.port}"
    opened = []
    try:
        assert wait(lambda: srv.ctx.bus.latest("left") is not None)
        for _ in range(2):
            r = urllib.request.urlopen(base + "/mjpeg/left", timeout=5)
            r.read(10)  # the stream is established
            opened.append(r)
        assert wait(lambda: srv.ctx.stream_clients == 2, timeout=5.0)
        code, body = _request(base + "/mjpeg/left")
        assert code == 503 and b"too many" in body
        code, body = _request(base + "/metrics")
        assert json.loads(body)["stream_clients"] == 2
    finally:
        for r in opened:
            r.close()
        srv.shutdown()


def test_shared_encode_cache():
    """Viewers of one slot share PNG encodes: the cache returns the
    identical object for the same (slot, seq) and a new one for the next
    frame."""
    srv = _server().start()
    try:
        bus = srv.ctx.bus
        assert wait(lambda: bus.latest("left") is not None)
        f = bus.latest("left")
        a = srv.ctx.encode_frame("left", f)
        b = srv.ctx.encode_frame("left", f)
        assert a is b  # the second call is the cache hit
        assert wait(lambda: bus.latest("left").seq > f.seq)
        assert srv.ctx.encode_frame("left", bus.latest("left")) is not a
    finally:
        srv.shutdown()


def test_multi_rig_routing():
    """A named rig runs its own pipeline over prefixed slots with its own
    parameters; the default rig is untouched."""
    assert split_slot("left") == ("", "left")
    assert split_slot("rig1.right") == ("rig1", "right")
    for bad in ("up", "rig1.mid", ".left", "a b.left"):
        with pytest.raises(ParamValidationError):
            split_slot(bad)

    mgr = _mgr()
    mgr.set_source("cam2.left", SyntheticSource(
        mgr.bus, "cam2.left", shape=(24, 48), fps=50.0, seed=5))
    mgr.set_source("cam2.right", SyntheticSource(
        mgr.bus, "cam2.right", shape=(24, 48), fps=50.0, shift=2, seed=5))
    pipe = DepthPipeline(mgr.bus, _matcher())
    rig = DepthPipeline(mgr.bus, _matcher(),
                        left_slot="cam2.left", right_slot="cam2.right",
                        out_slot="cam2.out", depth_slot="cam2.depth")
    srv = Server(AppContext(pipe, manager=mgr, rigs={"cam2": rig})).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        assert wait(lambda: mgr.bus.latest("cam2.out") is not None
                     and mgr.bus.latest("out") is not None)
        # both rigs stream independently
        assert _request(base + "/stream/out")[0] == 200
        code, body = _request(base + "/stream/cam2.out")
        assert code == 200 and body[:4] == b"\x89PNG"
        assert _request(base + "/stream/cam2.depth")[0] == 200
        # per-rig parameter update
        code, _ = _request(base + "/update-params",
                           data=b"blockSize=9&maxDisparity=32&rig=cam2")
        assert code == 200
        assert rig.matcher.get_params().block_size == 9
        assert pipe.matcher.get_params().block_size != 9
        # unknown rig -> 400
        code, _ = _request(base + "/update-params",
                           data=b"blockSize=9&maxDisparity=32&rig=nope")
        assert code == 400
        # /metrics reports the rig
        code, body = _request(base + "/metrics")
        assert "cam2" in json.loads(body).get("rigs", {})
    finally:
        srv.shutdown()


# -- the flags, through build_app ---------------------------------------------

@pytest.fixture(scope="module")
def pair_pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pair")
    rng = np.random.default_rng(99)
    left = rng.integers(0, 256, (24, 64), dtype=np.uint8)
    paths = (str(d / "l.png"), str(d / "r.png"))
    write_png(paths[0], left)
    write_png(paths[1], np.roll(left, -3, axis=1))
    return paths


def _build(pair, *flags):
    return build_app(["--device", "cpu", "--port", "0", "--no-open",
                      "--left", pair[0], "--right", pair[1], "--fps", "30",
                      *flags])


def test_auth_token_flag(pair_pngs):
    app = _build(pair_pngs, "--auth-token", "t0ken").start()
    try:
        assert _request(app.url + "/params")[0] == 401
        code, body = _request(app.url + "/params",
                              headers={"Authorization": "Bearer t0ken"})
        assert code == 200 and json.loads(body)["blockSize"] == 16
    finally:
        app.shutdown()


def test_tls_flags(pair_pngs, tmp_path):
    cert, key = _self_signed(tmp_path)
    app = _build(pair_pngs, "--tls-cert", cert, "--tls-key", key).start()
    try:
        assert app.url.startswith("https://")
        code, body = _request(app.url + "/checkhealth", sslctx=_insecure())
        assert code == 200 and body == b"OK"
    finally:
        app.shutdown()


def test_max_stream_clients_flag(pair_pngs):
    app = _build(pair_pngs, "--max-stream-clients", "1").start()
    opened = []
    try:
        ctx = app.server.ctx
        assert ctx.max_stream_clients == 1
        assert wait(lambda: ctx.bus.latest("left") is not None)
        r = urllib.request.urlopen(app.url + "/mjpeg/left", timeout=5)
        r.read(10)
        opened.append(r)
        assert wait(lambda: ctx.stream_clients == 1, timeout=5.0)
        assert _request(app.url + "/mjpeg/right")[0] == 503
    finally:
        for r in opened:
            r.close()
        app.shutdown()


def test_rig_flag_serves_each_rig(pair_pngs):
    """--rig NAME=L,R boots a second rig on its own pipeline and slots;
    --rig NAME alone waits for sources attached to NAME.left/NAME.right."""
    app = _build(pair_pngs, "--rig", f"b={pair_pngs[1]},{pair_pngs[0]}",
                 "--rig", "c").start()
    try:
        ctx = app.server.ctx
        assert set(ctx.rigs) == {"b", "c"}
        assert ctx.rigs["b"].left_slot == "b.left"
        assert ctx.rigs["c"].out_slot == "c.out"
        assert wait(lambda: ctx.bus.latest("b.out") is not None
                     and ctx.bus.latest("out") is not None)
        assert ctx.manager.get_source("c.left") is None
        assert ctx.bus.latest("c.out") is None
    finally:
        app.shutdown()
    with pytest.raises(SystemExit):
        _build(pair_pngs, "--rig", "a.b")


def test_serial_flag_attaches_serial_sources(pair_pngs):
    """--serial SLOT=DEVICE[@BAUD] attaches a SerialSource to the slot (a
    device that does not exist: the source retries with backoff), and the
    other side keeps its boot image."""
    app = _build(pair_pngs, "--serial", "left=/nonexistent/ttyX@115200")
    try:
        src = app.manager.get_source("left")
        assert isinstance(src, SerialSource)
        assert (src.device, src.baud) == ("/nonexistent/ttyX", 115200)
        assert isinstance(app.manager.get_source("right"), StaticSource)
        assert wait(lambda: src.reconnects >= 1, timeout=5.0)
    finally:
        app.shutdown()
    app = build_app(["--device", "cpu", "--port", "0", "--no-open",
                     "--serial", "left=/nonexistent/a", "--serial",
                     "right=/nonexistent/b"])
    try:
        assert {s.device for s in app.manager._sources.values()} == {
            "/nonexistent/a", "/nonexistent/b"}
        assert app.manager.get_source("left").baud == 921600
    finally:
        app.shutdown()
    with pytest.raises(SystemExit):
        build_app(["--device", "cpu", "--port", "0", "--serial", "left"])


def test_dedup_uploads_reaches_every_rig(pair_pngs):
    """--dedup-uploads is set on the default rig and on every --rig
    pipeline, and a static rig then computes its one distinct pair once."""
    app = _build(pair_pngs, "--dedup-uploads", "--rig",
                 f"b={pair_pngs[0]},{pair_pngs[1]}").start()
    try:
        ctx = app.server.ctx
        pipes = (ctx.pipeline, ctx.rigs["b"])
        assert all(p.dedup_uploads for p in pipes)
        assert wait(lambda: all(p.dup_skipped >= 3 for p in pipes))
        assert [p.frames for p in pipes] == [1, 1]
    finally:
        app.shutdown()
    app = _build(pair_pngs, "--rig", "b")
    try:
        assert not app.server.ctx.rigs["b"].dedup_uploads
    finally:
        app.shutdown()
