"""Minimal PGM (P5/P2) codec; a copy of
``steroscopic_hardware_tpu/io/pgm.py``.

The reference's HDL golden model emits ``disparity.pgm`` and ``.mem`` hex
vectors (``hardware/sad.c:66-142``); we keep PGM support for the same
golden-vector workflow.
"""

from __future__ import annotations

import numpy as np


def read_pgm(path) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # Parse header tokens, skipping comments.
    tokens = []
    i = 0
    while len(tokens) < 4:
        if data[i : i + 1] == b"#":
            while data[i : i + 1] not in (b"\n", b""):
                i += 1
        elif data[i : i + 1].isspace():
            i += 1
        else:
            j = i
            while not data[j : j + 1].isspace():
                j += 1
            tokens.append(data[i:j])
            i = j
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    i += 1  # single whitespace after maxval
    if magic == b"P5":
        dtype = np.uint8 if maxval < 256 else np.dtype(">u2")
        arr = np.frombuffer(data[i:], dtype=dtype, count=w * h)
        return arr.reshape(h, w).astype(np.uint8 if maxval < 256 else np.uint16)
    if magic == b"P2":
        vals = data[i:].split()
        arr = np.array([int(v) for v in vals[: w * h]], dtype=np.uint16)
        return arr.reshape(h, w).astype(np.uint8 if maxval < 256 else np.uint16)
    raise ValueError(f"unsupported PGM magic {magic!r}")


def write_pgm(path, array: np.ndarray) -> None:
    array = np.asarray(array)
    if array.ndim != 2:
        raise ValueError("PGM is grayscale-only")
    maxval = 255 if array.dtype == np.uint8 else 65535
    header = f"P5\n{array.shape[1]} {array.shape[0]}\n{maxval}\n".encode()
    body = array.tobytes() if array.dtype == np.uint8 else array.astype(">u2").tobytes()
    with open(path, "wb") as f:
        f.write(header + body)
