"""LZMA frame codec.

Capability parity with the reference's in-tree LZMA SDK port
(``pkg/lzma/``: streaming reader/writer, compression levels 1-9,
known-size and unknown-size headers, ``encoder.go:40-117`` /
``decoder.go:47``) built on the stdlib ``lzma`` module in
``FORMAT_ALONE`` mode, which produces the same classic .lzma container
(13-byte header: properties byte, dict size, 8-byte size field —
0xFFFFFFFFFFFFFFFF for unknown size) the reference emits.

Used as codec id 2 in the stereo frame wire protocol
(``native/shtpu_native.cpp``).

The port's own copy of ``steroscopic_hardware_tpu/io/lzma_codec.py``,
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import lzma

# Reference level table (pkg/lzma/encoder.go: levels map to dict sizes
# 64K..64M): stdlib presets 1-9 provide the equivalent envelope.
LEVELS = range(1, 10)


def _filters(level: int):
    if level not in LEVELS:
        raise ValueError(f"compression level {level} out of range [1, 9]")
    return [{"id": lzma.FILTER_LZMA1, "preset": level}]


def compress(data: bytes, level: int = 5) -> bytes:
    """One-shot compress with unknown-size header (NewWriterLevel
    equivalent, pkg/lzma/encoder.go:99-117)."""
    return lzma.compress(
        data, format=lzma.FORMAT_ALONE, filters=_filters(level)
    )


def decompress(data: bytes) -> bytes:
    """One-shot decompress, both known- and unknown-size headers
    (NewReader equivalent, pkg/lzma/decoder.go:47)."""
    return lzma.decompress(data, format=lzma.FORMAT_ALONE)


def compress_known_size(data: bytes, level: int = 5) -> bytes:
    """Compress with the uncompressed size recorded in the header
    (NewWriterSizeLevel equivalent, pkg/lzma/encoder.go:40-76)."""
    body = lzma.compress(
        data, format=lzma.FORMAT_ALONE, filters=_filters(level)
    )
    # Patch the 8-byte size field (bytes 5..13, little-endian).
    size = len(data).to_bytes(8, "little")
    return body[:5] + size + body[13:]


class Writer:
    """Streaming compressor (io.Writer-style)."""

    def __init__(self, level: int = 5):
        self._c = lzma.LZMACompressor(
            format=lzma.FORMAT_ALONE, filters=_filters(level)
        )
        self._chunks: list[bytes] = []
        self._closed = False

    def write(self, data: bytes) -> int:
        out = self._c.compress(data)
        if out:
            self._chunks.append(out)
        return len(data)

    def close(self) -> bytes:
        if not self._closed:
            self._chunks.append(self._c.flush())
            self._closed = True
        return b"".join(self._chunks)


class Reader:
    """Streaming decompressor (io.Reader-style)."""

    def __init__(self):
        self._d = lzma.LZMADecompressor(format=lzma.FORMAT_ALONE)

    def read(self, data: bytes) -> bytes:
        return self._d.decompress(data)

    @property
    def eof(self) -> bool:
        return self._d.eof
