"""The port's camera transports on the CPU, as ``tests/test_runtime.py`` and
``tests/test_lzma_interop.py`` hold the JAX ones: the wire protocol in each
codec, the native parser against the Python one, ``CameraEmitter`` into
``TcpSource`` over a real socket (each compressed codec live, reconnect),
the LZMA codec and its container, and the pipeline's latency decomposition,
queue cap and ``--dedup-uploads``.

Where both packages produce a result they run on the same seeded numpy
input and must agree exactly (bytes and integers): the encoded frames per
codec, a JAX emitter into a port source and the other way round, and the
depth the port's server serves from a TCP feed against the JAX plain map
(``ops/sad_golden.py``). The cases of ``tests/test_runtime.py`` that
``tests/test_torch_server.py`` already holds (the serve layouts, light
fetch and host colorize) are not repeated.
"""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu.io import lzma_codec as jax_lzma
from steroscopic_hardware_tpu.models.blockmatch import (
    BlockMatcher as JaxBlockMatcher,
)
from steroscopic_hardware_tpu.ops.sad_golden import disparity_numpy
from steroscopic_hardware_tpu.runtime import wire as jax_wire
from steroscopic_hardware_tpu.runtime.bus import FrameBus as JaxFrameBus
from steroscopic_hardware_tpu.runtime.emitter import (
    CameraEmitter as JaxCameraEmitter,
)
from steroscopic_hardware_tpu.runtime.sources import TcpSource as JaxTcpSource
from steroscopic_hardware_tpu.utils.params import Parameters as JaxParameters
from steroscopic_hardware_tpu_torch.io import lzma_codec
from steroscopic_hardware_tpu_torch.models.blockmatch import BlockMatcher
from steroscopic_hardware_tpu_torch.runtime import wire
from steroscopic_hardware_tpu_torch.runtime.bus import FrameBus
from steroscopic_hardware_tpu_torch.runtime.emitter import CameraEmitter
from steroscopic_hardware_tpu_torch.runtime.manager import CameraManager
from steroscopic_hardware_tpu_torch.runtime.pipeline import DepthPipeline
from steroscopic_hardware_tpu_torch.runtime.sources import (
    StaticSource,
    SyntheticSource,
    TcpSource,
)
from steroscopic_hardware_tpu_torch.utils.params import Parameters

from torch_wait import wait

CODECS = [wire.CODEC_RAW, wire.CODEC_RANGE, wire.CODEC_LZMA]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # six test workers share the machine's cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- wire protocol ------------------------------------------------------------

@pytest.mark.parametrize("codec", CODECS)
def test_wire_roundtrip(rng, codec):
    frame = rng.integers(0, 256, (24, 32), dtype=np.uint8)
    blob = wire.encode_frame(frame, codec=codec)
    parser = wire.FrameParser()
    # feed in awkward chunk sizes with garbage prefix
    stream = b"junk\xff" + blob + b"\xfftail"
    got = []
    for i in range(0, len(stream), 7):
        got.extend(parser.feed(stream[i: i + 7]))
    assert len(got) == 1
    assert np.array_equal(got[0], frame)
    assert parser.bytes_dropped >= 5


@pytest.mark.parametrize("codec", CODECS)
def test_encode_frame_bytes_equal_jax(rng, codec):
    """The port's copy of the wire encoder writes the JAX package's bytes."""
    for shape in ((1, 1), (24, 32), (61, 97)):
        frame = rng.integers(0, 256, shape, dtype=np.uint8)
        assert (wire.encode_frame(frame, codec=codec)
                == jax_wire.encode_frame(frame, codec=codec))


def test_wire_multiple_frames(rng):
    frames = [rng.integers(0, 256, (8, 16), dtype=np.uint8)
              for _ in range(3)]
    stream = b"".join(wire.encode_frame(f) for f in frames)
    parser = wire.FrameParser()
    got = parser.feed(stream)
    assert len(got) == 3
    for a, b in zip(frames, got):
        assert np.array_equal(a, b)


def test_native_parser_matches_python(rng):
    """The C++ parser behaves as the Python one, including resync over
    garbage and multi-frame chunked feeds."""
    from steroscopic_hardware_tpu_torch._native import get_lib

    lib = get_lib()
    assert lib is not None, "the native library did not build"
    frames = [rng.integers(0, 256, (8, 16), dtype=np.uint8)
              for _ in range(3)]
    stream = (b"junk\xff" + wire.encode_frame(frames[0])
              + b"\x00\x01" + wire.encode_frame(frames[1])
              + wire.encode_frame(frames[2]) + b"tail")
    for chunk in (7, 64, len(stream)):
        py, nat = wire.FrameParser(), wire.NativeFrameParser(lib)
        got_py, got_nat = [], []
        for i in range(0, len(stream), chunk):
            got_py.extend(py.feed(stream[i:i + chunk]))
            got_nat.extend(nat.feed(stream[i:i + chunk]))
        assert len(got_py) == len(got_nat) == 3
        for a, b in zip(got_py, got_nat):
            assert np.array_equal(a, b)
    assert isinstance(wire.make_parser(), wire.NativeFrameParser)


# -- CameraEmitter <-> TcpSource over a real socket ---------------------------

def test_tcp_source_receives_frames(rng):
    base = rng.integers(0, 256, (16, 32), dtype=np.uint8)
    emitter = CameraEmitter(lambda n: np.roll(base, n, axis=1),
                            fps=200.0).start()
    bus = FrameBus()
    src = TcpSource(bus, "left", "127.0.0.1", emitter.port)
    src.start()
    try:
        assert wait(lambda: bus.seq("left") >= 3)
        got = bus.latest("left").data
        assert got.shape == (16, 32)
        assert any(np.array_equal(got, np.roll(base, k, axis=1))
                   for k in range(32))
        assert isinstance(src.parser, wire.NativeFrameParser)
    finally:
        src.close()
        emitter.close()


@pytest.mark.parametrize("codec", [wire.CODEC_RANGE, wire.CODEC_LZMA])
def test_tcp_source_compressed_codecs_live(rng, codec):
    """A CameraEmitter streaming codec 1 (native range coder) / 2 (LZMA)
    into a TcpSource over a real socket delivers frames bit-exactly."""
    base = rng.integers(0, 256, (24, 40), dtype=np.uint8)
    emitter = CameraEmitter(lambda n: np.roll(base, n % 7, axis=1),
                            fps=200.0, codec=codec).start()
    bus = FrameBus()
    src = TcpSource(bus, "left", "127.0.0.1", emitter.port)
    src.start()
    try:
        assert wait(lambda: bus.seq("left") >= 5)
        f = bus.latest("left")
        variants = [np.roll(base, k, axis=1) for k in range(7)]
        assert any(np.array_equal(f.data, v) for v in variants)
    finally:
        src.close()
        emitter.close()


def test_tcp_source_reconnects():
    """The source retries with backoff while the endpoint is down."""
    bus = FrameBus()
    src = TcpSource(bus, "left", "127.0.0.1", 1)  # nothing listens on :1
    src.start()
    try:
        assert wait(lambda: src.reconnects >= 2, timeout=5.0)
    finally:
        src.close()


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_emitters_and_sources_interoperate_with_jax(rng, codec, direction):
    """A JAX CameraEmitter feeds a port TcpSource, and a port emitter a
    JAX source: the received frames are the emitted ones."""
    frames = [rng.integers(0, 256, (20, 36), dtype=np.uint8)
              for _ in range(3)]
    if direction == "jax-to-port":
        em_cls, src_cls, bus = JaxCameraEmitter, TcpSource, FrameBus()
    else:
        em_cls, src_cls, bus = CameraEmitter, JaxTcpSource, JaxFrameBus()
    emitter = em_cls(lambda n: frames[n % 3], fps=200.0, codec=codec).start()
    got = []
    publish = bus.publish

    def record(name, data, source=""):
        got.append(np.array(data))
        return publish(name, data, source=source)

    bus.publish = record
    src = src_cls(bus, "left", "127.0.0.1", emitter.port).start()
    try:
        assert wait(lambda: len(got) >= 4)
    finally:
        src.close()
        emitter.close()
    for g in got:
        assert any(np.array_equal(g, f) for f in frames)


# -- the server fed over TCP --------------------------------------------------

@pytest.mark.parametrize("codec,lr", [(wire.CODEC_RAW, False),
                                      (wire.CODEC_LZMA, True)])
def test_tcp_fed_server_serves_the_jax_plain_map(tmp_path, codec, lr):
    """``POST /left/configure`` and ``/right/configure`` attach TCP sources
    to two emitters; ``/ports`` lists them, and ``/stream/out`` equals the
    JAX golden model's map of the pair (with --lr-check the JAX matcher's
    LR-checked map)."""
    from steroscopic_hardware_tpu_torch.__main__ import build_app
    from steroscopic_hardware_tpu_torch.io.png import read_png
    from steroscopic_hardware_tpu_torch.serve_probe import (
        attach_emitters,
        textured_pair,
    )

    left, right = textured_pair(5, 32, 96, shift=6)
    app = build_app(["--device", "cpu", "--port", "0", "--no-open",
                     *(["--lr-check"] if lr else [])]).start()
    emitters = attach_emitters(app.url, {"left": left, "right": right},
                               codec, 60.0)
    try:
        pipe = app.server.ctx.pipeline
        # a frame computed after both sources delivered
        assert wait(lambda: pipe.frames >= 3, timeout=30.0)
        with urllib.request.urlopen(app.url + "/stream/out") as r:
            got = read_png(r.read())
        with urllib.request.urlopen(app.url + "/ports") as r:
            ports = json.load(r)["ports"]
    finally:
        app.shutdown()
        for em in emitters:
            em.close()
    if lr:
        want = JaxBlockMatcher(JaxParameters(16, 64),
                               backend="xla").compute_checked(left, right)[0]
    else:
        want = disparity_numpy(left, right, 16, 64)
    assert np.array_equal(got, want)
    configured = {p["slot"]: p["port"] for p in ports
                  if p["kind"] == "configured"}
    assert configured == {"left": emitters[0].port,
                          "right": emitters[1].port}
    assert {e.port for e in emitters} <= {p["port"] for p in ports
                                          if p["kind"] == "emitter"}


# -- lzma codec ---------------------------------------------------------------

def test_lzma_roundtrip_levels(rng):
    data = rng.integers(0, 50, 10_000, dtype=np.uint8).tobytes()
    for level in (1, 5, 9):
        enc = lzma_codec.compress(data, level)
        assert lzma_codec.decompress(enc) == data
        assert len(enc) < len(data)
        assert enc == jax_lzma.compress(data, level)


def test_lzma_known_size_header():
    data = b"steroscopic" * 500
    enc = lzma_codec.compress_known_size(data, 5)
    # header size field holds the payload length
    assert int.from_bytes(enc[5:13], "little") == len(data)
    assert lzma_codec.decompress(enc) == data
    assert enc == jax_lzma.compress_known_size(data, 5)


def test_lzma_streaming(rng):
    data = rng.integers(0, 10, 50_000, dtype=np.uint8).tobytes()
    w = lzma_codec.Writer(level=3)
    for i in range(0, len(data), 4096):
        w.write(data[i: i + 4096])
    enc = w.close()
    r = lzma_codec.Reader()
    out = b"".join(r.read(enc[i: i + 1024])
                   for i in range(0, len(enc), 1024))
    assert out == data
    assert jax_lzma.decompress(enc) == data


def test_lzma_empty():
    assert lzma_codec.decompress(lzma_codec.compress(b"")) == b""


def test_lzma_bad_level():
    with pytest.raises(ValueError):
        lzma_codec.compress(b"x", 0)
    with pytest.raises(ValueError):
        lzma_codec.compress(b"x", 10)


# The reference's golden byte-vectors (``pkg/lzma/decoder_test.go``), as
# ``tests/test_lzma_interop.py`` carries them: both header modes.
GOLDEN = [
    ("empty, size known", b"", bytes([
        0x5D, 0x00, 0x00, 0x10, 0x00, 0x00, 0x00, 0x00,
        0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
        0x00, 0x00])),
    ("empty, size unknown", b"", bytes([
        0x5D, 0x00, 0x00, 0x10, 0x00, 0xFF, 0xFF, 0xFF,
        0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0x00, 0x83, 0xFF,
        0xFB, 0xFF, 0xFF, 0xC0, 0x00, 0x00, 0x00])),
    ("hello world, size known", b"hello world\n", bytes([
        0x5D, 0x00, 0x00, 0x10, 0x00, 0x0C, 0x00, 0x00,
        0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x34, 0x19,
        0x49, 0xEE, 0x8D, 0xE9, 0x17, 0x89, 0x3A, 0x33,
        0x5F, 0xFC, 0xAC, 0xF7, 0x20, 0x00])),
    ("hello world, size unknown", b"hello world\n", bytes([
        0x5D, 0x00, 0x00, 0x10, 0x00, 0xFF, 0xFF, 0xFF,
        0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0x00, 0x34, 0x19,
        0x49, 0xEE, 0x8D, 0xE9, 0x17, 0x89, 0x3A, 0x33,
        0x5F, 0xFC, 0xB2, 0x09, 0x82, 0x2F, 0xFF, 0xFD,
        0xE2, 0x80, 0x00])),
]


@pytest.mark.parametrize("desc,raw,blob", GOLDEN, ids=[g[0] for g in GOLDEN])
def test_decode_reference_golden_vectors(desc, raw, blob):
    assert lzma_codec.decompress(blob) == raw


def test_our_streams_use_the_reference_container():
    """The encoder's output is the classic .lzma container: the 13-byte
    header (props byte with valid lc/lp/pb, little-endian dictionary size,
    8-byte size field: all ones unknown / the exact length known),
    decodable in both modes."""
    payload = b"connerohnesorge" * 3
    for level in (1, 5, 9):
        blob = lzma_codec.compress(payload, level=level)
        assert blob[0] < 9 * 5 * 5  # lc/lp/pb in range (0x5d default)
        assert blob[5:13] == b"\xff" * 8
        assert lzma_codec.decompress(blob) == payload

        known = lzma_codec.compress_known_size(payload, level=level)
        assert int.from_bytes(known[5:13], "little") == len(payload)
        assert lzma_codec.decompress(known) == payload


# -- the pipeline: latency decomposition, queue cap, dedup -------------------

def _synthetic_rig(shape=(32, 64), fps=200.0):
    mgr = CameraManager()
    mgr.set_source("left", SyntheticSource(
        mgr.bus, "left", shape=shape, fps=fps, shift=0, seed=7))
    mgr.set_source("right", SyntheticSource(
        mgr.bus, "right", shape=shape, fps=fps, shift=4, seed=7))
    return mgr


def test_pipeline_latency_decomposition_and_queue_cap():
    """The capture->publish latency decomposition (queue / serve / host,
    p50 and p95) is in the metrics, and the capped inbox turns backlog
    into counted ``queue_dropped``, never silent loss."""
    mgr = _synthetic_rig()

    class SlowMatcher(BlockMatcher):
        # deterministic backlog: +80 ms a batch against 200 fps sources
        def compute_serve_async(self, pairs, **kw):
            time.sleep(0.08)
            return super().compute_serve_async(pairs, **kw)

    matcher = SlowMatcher(Parameters(7, 16), device="cpu")
    pipe = DepthPipeline(mgr.bus, matcher, max_batch=2, max_queue=2).start()
    try:
        assert wait(lambda: pipe.frames >= 6, timeout=30.0)
        m = pipe.metrics()
        for part in ("queue", "serve", "host"):
            assert f"lat_{part}_p50" in m, m
            assert f"lat_{part}_p95" in m, m
        assert m["lat_serve_p50"] > 0
        # an 80 ms/frame pipeline against 200 fps sources overflows the
        # 2-deep inbox: backlog shows up as counted drops, not lag
        assert wait(lambda: pipe.queue_dropped > 0, timeout=10.0), (
            pipe.metrics())
    finally:
        pipe.close()
        mgr.close_all()


def test_dedup_uploads_skips_identical_pairs():
    """--dedup-uploads: byte-identical consecutive pairs never reach the
    compute batch (paused or static feeds)."""
    bus = FrameBus()
    frame = np.random.default_rng(0).integers(0, 256, (64, 96), np.uint8)
    m = BlockMatcher(Parameters(7, 16), device="cpu")
    pipe = DepthPipeline(bus, m, colorize=False, dedup_uploads=True)
    left = StaticSource(bus, "left", frame, fps=60.0).start()
    right = StaticSource(bus, "right", frame, fps=60.0).start()
    pipe.start()
    try:
        assert wait(lambda: pipe.frames >= 1, timeout=30.0)
        # the re-published clones do not compute
        assert wait(lambda: pipe.dup_skipped > 10, timeout=10.0)
        assert pipe.frames <= 3
    finally:
        left.close()
        right.close()
        pipe.close()
    assert pipe.batches == pipe.frames
