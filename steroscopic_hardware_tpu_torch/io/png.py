"""A self-contained PNG codec (numpy + stdlib zlib).

Capability parity with the reference's PNG layer (``pkg/despair/png.go:10-75``:
load-and-convert-to-gray, save) without any third-party imaging dependency.
Supports the formats found in the reference's ``testdata/`` (8-bit RGB /
RGBA, non-interlaced) plus 8/16-bit grayscale, gray+alpha, and palette
images; all five scanline filters are implemented.

Decoding returns raw channel data; grayscale conversion lives in
``ops/gray.py`` so it can replicate the reference's exact integer luma.

The port's own copy of ``steroscopic_hardware_tpu/io/png.py``,
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"

# color type -> number of channels
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PNGError(ValueError):
    pass


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    # int16 arithmetic is enough: values in [0, 255]
    p = a.astype(np.int16) + b.astype(np.int16) - c.astype(np.int16)
    pa = np.abs(p - a)
    pb = np.abs(p - b)
    pc = np.abs(p - c)
    out = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return out.astype(np.uint8)


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo per-scanline filtering. Returns (height, stride) uint8.

    Uses the C++ native path (``native/shtpu_native.cpp``) when available;
    falls back to pure numpy/Python.
    """
    rows = np.frombuffer(raw, dtype=np.uint8)
    if rows.size != height * (stride + 1):
        raise PNGError(
            f"decompressed size {rows.size} != expected {height * (stride + 1)}"
        )
    rows = rows.reshape(height, stride + 1)

    from steroscopic_hardware_tpu_torch._native import get_lib

    lib = get_lib()
    if lib is not None:
        import ctypes

        rows_c = np.ascontiguousarray(rows)
        out = np.empty((height, stride), dtype=np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        rc = lib.shtpu_png_unfilter(
            rows_c.ctypes.data_as(u8p), height, stride, bpp,
            out.ctypes.data_as(u8p),
        )
        if rc != 0:
            raise PNGError("unknown filter type")
        return out

    filters = rows[:, 0]
    data = rows[:, 1:].copy()
    out = np.zeros((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(height):
        f = filters[y]
        line = data[y]
        if f == 0:
            cur = line
        elif f == 1:  # Sub
            cur = line.copy()
            for x in range(bpp, stride):
                cur[x] = (int(cur[x]) + int(cur[x - bpp])) & 0xFF
        elif f == 2:  # Up
            cur = (line.astype(np.int16) + prev).astype(np.uint8)
        elif f == 3:  # Average
            cur = line.copy()
            for x in range(stride):
                left = int(cur[x - bpp]) if x >= bpp else 0
                cur[x] = (int(line[x]) + ((left + int(prev[x])) >> 1)) & 0xFF
        elif f == 4:  # Paeth
            cur = line.copy()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else np.uint8(0)
                ul = prev[x - bpp] if x >= bpp else np.uint8(0)
                pred = _paeth(
                    np.asarray(left), np.asarray(prev[x]), np.asarray(ul)
                )
                cur[x] = (int(line[x]) + int(pred)) & 0xFF
        else:
            raise PNGError(f"unknown filter type {f}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path_or_bytes) -> np.ndarray:
    """Decode a PNG file.

    Returns a numpy array:
      - grayscale        -> (H, W)        uint8/uint16
      - gray+alpha       -> (H, W, 2)
      - RGB              -> (H, W, 3)
      - RGBA / palette   -> (H, W, 4) / (H, W, 3)
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    if buf[:8] != _PNG_SIG:
        raise PNGError("not a PNG file")

    pos = 8
    width = height = None
    bitdepth = colortype = interlace = None
    idat = []
    palette = None
    trns = None
    while pos < len(buf):
        (length,) = struct.unpack(">I", buf[pos : pos + 4])
        ctype = buf[pos + 4 : pos + 8]
        body = buf[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            width, height, bitdepth, colortype, _comp, _filt, interlace = (
                struct.unpack(">IIBBBBB", body)
            )
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(body, dtype=np.uint8)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if width is None:
        raise PNGError("missing IHDR")
    if interlace != 0:
        raise PNGError("interlaced PNG not supported")
    if colortype not in _CHANNELS:
        raise PNGError(f"unsupported color type {colortype}")
    if bitdepth not in (8, 16) and not (colortype == 3 and bitdepth in (1, 2, 4, 8)):
        raise PNGError(f"unsupported bit depth {bitdepth}")

    nchan = _CHANNELS[colortype]
    raw = zlib.decompress(b"".join(idat))

    if colortype == 3 and bitdepth < 8:
        # bit-packed palette indices
        stride = (width * bitdepth + 7) // 8
        bpp = 1
        arr = _unfilter(raw, height, stride, bpp)
        bits = np.unpackbits(arr, axis=1)[:, : width * bitdepth]
        bits = bits.reshape(height, width, bitdepth)
        weights = (1 << np.arange(bitdepth - 1, -1, -1)).astype(np.uint8)
        idx = (bits * weights).sum(axis=2).astype(np.uint8)
        data = idx
    else:
        bytes_per_sample = bitdepth // 8
        stride = width * nchan * bytes_per_sample
        bpp = max(1, nchan * bytes_per_sample)
        arr = _unfilter(raw, height, stride, bpp)
        if bitdepth == 16:
            data = arr.reshape(height, width, nchan, 2)
            data = (
                data[..., 0].astype(np.uint16) << 8 | data[..., 1].astype(np.uint16)
            )
        else:
            data = arr.reshape(height, width, nchan)
        if nchan == 1:
            data = data[..., 0]

    if colortype == 3:
        if palette is None:
            raise PNGError("palette image missing PLTE")
        rgb = palette[data]
        if trns is not None:
            alpha = np.full(data.shape, 255, dtype=np.uint8)
            n = min(len(trns), palette.shape[0])
            lut = np.full(palette.shape[0], 255, dtype=np.uint8)
            lut[:n] = trns[:n]
            alpha = lut[data]
            return np.dstack([rgb, alpha])
        return rgb
    return data


def _filter_sub(data: np.ndarray, bpp: int) -> np.ndarray:
    shifted = np.zeros_like(data)
    shifted[:, bpp:] = data[:, :-bpp]
    return (data.astype(np.int16) - shifted).astype(np.uint8)


def write_png(path, array: np.ndarray, compress_level: int = 6) -> bytes:
    """Encode a numpy array as PNG (8-bit gray / gray+alpha / RGB / RGBA,
    or 16-bit gray). ``path=None`` returns the encoded bytes only.

    Mirrors ``pkg/despair/png.go:55-75`` (SavePNG); the reference uses
    BestSpeed — we default to zlib level 6 and let callers lower it for
    the hot streaming path.
    """
    array = np.asarray(array)
    if array.dtype == np.uint16:
        if array.ndim != 2:
            raise PNGError("16-bit encode only supported for grayscale")
        colortype, bitdepth, nchan = 0, 16, 1
        body = array.astype(">u2").tobytes()
        stride = array.shape[1] * 2
        raw_rows = np.frombuffer(body, dtype=np.uint8).reshape(
            array.shape[0], stride
        )
        bpp = 2
    elif array.dtype == np.uint8:
        if array.ndim == 2:
            colortype, nchan = 0, 1
        elif array.ndim == 3 and array.shape[2] in (1, 2, 3, 4):
            nchan = array.shape[2]
            colortype = {1: 0, 2: 4, 3: 2, 4: 6}[nchan]
            if nchan == 1:
                array = array[..., 0]
        else:
            raise PNGError(f"unsupported array shape {array.shape}")
        bitdepth = 8
        raw_rows = array.reshape(array.shape[0], -1)
        stride = raw_rows.shape[1]
        bpp = nchan
    else:
        raise PNGError(f"unsupported dtype {array.dtype}")

    height = array.shape[0]
    width = array.shape[1]

    # Sub filter: cheap and effective on natural images.
    filtered = _filter_sub(np.ascontiguousarray(raw_rows), bpp)
    scanlines = np.zeros((height, stride + 1), dtype=np.uint8)
    scanlines[:, 0] = 1  # filter type Sub
    scanlines[:, 1:] = filtered
    compressed = zlib.compress(scanlines.tobytes(), compress_level)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", width, height, bitdepth, colortype, 0, 0, 0)
    out = (
        _PNG_SIG
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", compressed)
        + chunk(b"IEND", b"")
    )
    if path is not None:
        with open(path, "wb") as f:
            f.write(out)
    return out
