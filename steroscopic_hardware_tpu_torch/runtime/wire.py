"""Stereo frame wire protocol (TCP replacement for the UART link).

Protocol semantics carried over from the reference
(``pkg/camera/serial.go:17-27``, ``Vitis/.../camera_app.c:11-12,130-233``):
the consumer sends ``0xFF 0xD8`` to start, the camera acks ``0x01`` and
streams frames, ``0xFF 0xD9`` stops. Where the reference streams exactly
W*H raw bytes per request at a fixed 1920x1080, the TCP framing adds a
13-byte header (u32le width, u32le height, u8 codec, u32le payload length)
per frame so resolutions and codecs can vary per stream:

  0xFF 0xD8 | header | payload | 0xFF 0xD9

Codecs: 0 = raw grayscale, 1 = adaptive range coder (native C++), 2 = LZMA.

Parsing uses the C++ incremental parser (``native/shtpu_native.cpp``) when
available, with a pure-Python fallback.

The port's own copy of ``steroscopic_hardware_tpu/runtime/wire.py``,
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

START_SEQ = b"\xff\xd8"
END_SEQ = b"\xff\xd9"
ACK = b"\x01"

CODEC_RAW = 0
CODEC_RANGE = 1
CODEC_LZMA = 2

_HDR = struct.Struct("<IIBI")


def _decode_payload(payload: bytes, codec: int, width: int,
                    height: int) -> np.ndarray:
    if codec == CODEC_RAW:
        raw = payload
    elif codec == CODEC_RANGE:
        from steroscopic_hardware_tpu_torch._native import get_lib

        lib = get_lib()
        if lib is None:
            raise RuntimeError("range codec requires the native library")
        out = np.empty(width * height, np.uint8)
        enc = np.frombuffer(payload, np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.shtpu_rc_decode(
            enc.ctypes.data_as(u8p), len(enc),
            out.ctypes.data_as(u8p), out.size,
        )
        raw = out.tobytes()
    elif codec == CODEC_LZMA:
        from steroscopic_hardware_tpu_torch.io import lzma_codec

        raw = lzma_codec.decompress(payload)
    else:
        raise ValueError(f"unknown codec {codec}")
    return np.frombuffer(raw, np.uint8).reshape(height, width)


def encode_frame(frame: np.ndarray, codec: int = CODEC_RAW,
                 level: int = 1) -> bytes:
    """Encode one frame into the wire format."""
    height, width = frame.shape
    if codec == CODEC_RAW:
        payload = frame.tobytes()
    elif codec == CODEC_RANGE:
        from steroscopic_hardware_tpu_torch._native import get_lib

        lib = get_lib()
        if lib is None:
            raise RuntimeError("range codec requires the native library")
        data = np.ascontiguousarray(frame).reshape(-1)
        cap = data.size * 2 + 64
        out = np.empty(cap, np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        n = lib.shtpu_rc_encode(
            data.ctypes.data_as(u8p), data.size,
            out.ctypes.data_as(u8p), cap,
        )
        payload = out[:n].tobytes()
    elif codec == CODEC_LZMA:
        from steroscopic_hardware_tpu_torch.io import lzma_codec

        payload = lzma_codec.compress(frame.tobytes(), level=level)
    else:
        raise ValueError(f"unknown codec {codec}")
    return (
        START_SEQ
        + _HDR.pack(width, height, codec, len(payload))
        + payload
        + END_SEQ
    )


class NativeFrameParser:
    """Incremental parser backed by the C++ state machine
    (``shtpu_frame_parser`` in ``native/shtpu_native.cpp``) — the hot
    ingest path. Same interface as :class:`FrameParser`."""

    def __init__(self, lib):
        self._lib = lib
        self._p = lib.shtpu_parser_new()
        self._pending = bytearray()
        self.decode_errors = 0

    def __del__(self):
        try:
            self._lib.shtpu_parser_free(self._p)
        except Exception:
            pass

    @property
    def frames(self):
        return self._lib.shtpu_parser_frames(self._p)

    @property
    def bytes_dropped(self):
        return self._lib.shtpu_parser_dropped(self._p)

    def feed(self, data: bytes):
        import numpy as np

        out = []
        self._pending.extend(data)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        while self._pending:
            arr = np.frombuffer(bytes(self._pending), np.uint8)
            consumed = self._lib.shtpu_parser_feed(
                self._p, arr.ctypes.data_as(u8p), arr.size
            )
            del self._pending[:max(consumed, 0)]
            if self._lib.shtpu_parser_frame_ready(self._p):
                w = self._lib.shtpu_parser_width(self._p)
                h = self._lib.shtpu_parser_height(self._p)
                plen = self._lib.shtpu_parser_payload_len(self._p)
                codec = self._lib.shtpu_parser_codec(self._p)
                payload = np.empty(plen, np.uint8)
                self._lib.shtpu_parser_take(
                    self._p, payload.ctypes.data_as(u8p)
                )
                try:
                    out.append(
                        _decode_payload(payload.tobytes(), codec, w, h)
                    )
                except Exception:
                    self.decode_errors += 1
            elif consumed >= arr.size or consumed <= 0:
                break
        return out


def make_parser():
    """Best parser available: C++ when the native lib loads, else Python."""
    from steroscopic_hardware_tpu_torch._native import get_lib

    lib = get_lib()
    return NativeFrameParser(lib) if lib is not None else FrameParser()


class FrameParser:
    """Incremental parser: feed arbitrary byte chunks, yield frames.

    Pure-Python implementation of the same state machine as the C++
    ``shtpu_frame_parser``; resyncs on garbage between frames the way the
    serial reader scans for the start marker.
    """

    MAX_DIM = 16384

    def __init__(self):
        self._buf = bytearray()
        self.frames = 0
        self.bytes_dropped = 0
        self.decode_errors = 0

    def feed(self, data: bytes):
        self._buf.extend(data)
        out = []
        while True:
            idx = self._buf.find(START_SEQ)
            if idx < 0:
                # keep a possible trailing partial start byte
                keep = 1 if self._buf.endswith(b"\xff") else 0
                self.bytes_dropped += len(self._buf) - keep
                del self._buf[: len(self._buf) - keep]
                break
            if idx > 0:
                self.bytes_dropped += idx
                del self._buf[:idx]
            if len(self._buf) < 2 + _HDR.size:
                break
            width, height, codec, plen = _HDR.unpack_from(self._buf, 2)
            if (
                not 0 < width <= self.MAX_DIM
                or not 0 < height <= self.MAX_DIM
                or codec > CODEC_LZMA
                or plen > (1 << 28)
            ):
                # garbage header: drop the marker and resync
                self.bytes_dropped += 2
                del self._buf[:2]
                continue
            total = 2 + _HDR.size + plen + 2
            if len(self._buf) < total:
                break
            payload = bytes(self._buf[2 + _HDR.size : 2 + _HDR.size + plen])
            trailer = bytes(self._buf[total - 2 : total])
            del self._buf[:total]
            if trailer != END_SEQ:
                self.bytes_dropped += 2
            try:
                out.append(_decode_payload(payload, codec, width, height))
                self.frames += 1
            except Exception:
                # corrupt payload (bad codec stream / size mismatch):
                # count it and keep parsing — a stream must survive any
                # byte corruption.
                self.decode_errors += 1
        return out
