"""Checkpoint / resume (a copy of ``utils/checkpoint.py``).

The SLAM engine persists its whole state (parameters, trajectory, keyframe
window, keyframe history, pose graph) atomically (write-temp + rename) in
versioned, checksummed archives: an ``.npz`` payload plus a JSON manifest
in one zip file, with listing and pruning. The format is the JAX
package's, field for field, so a checkpoint written by either package
resumes in the other.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
import time
import zipfile

import numpy as np

FORMAT_VERSION = 1
_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"


def save(path: str, arrays: dict, meta: dict | None = None) -> dict:
    """Atomically write a checkpoint. Returns the manifest."""
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
    payload = buf.getvalue()
    manifest = {
        "format_version": FORMAT_VERSION,
        "created": time.time(),
        "arrays": {
            k: {"shape": list(np.asarray(v).shape),
                "dtype": str(np.asarray(v).dtype)}
            for k, v in arrays.items()
        },
        "sha256": hashlib.sha256(payload).hexdigest(),
        "meta": meta or {},
    }
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED) as z:
                z.writestr(_MANIFEST, json.dumps(manifest, indent=1))
                z.writestr(_ARRAYS, payload)
        os.replace(tmp, path)  # atomic on POSIX
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return manifest


class CorruptCheckpoint(ValueError):
    pass


def load(path: str) -> tuple[dict, dict]:
    """Load a checkpoint -> (arrays, manifest). Verifies the checksum."""
    with zipfile.ZipFile(path) as z:
        manifest = json.loads(z.read(_MANIFEST))
        payload = z.read(_ARRAYS)
    if manifest.get("format_version") != FORMAT_VERSION:
        raise CorruptCheckpoint(
            f"unsupported format {manifest.get('format_version')}"
        )
    if hashlib.sha256(payload).hexdigest() != manifest["sha256"]:
        raise CorruptCheckpoint("payload checksum mismatch")
    with np.load(io.BytesIO(payload)) as npz:
        arrays = {k: npz[k] for k in npz.files}
    return arrays, manifest


def latest(directory: str, prefix: str = "slam") -> str | None:
    """Newest checkpoint path matching ``{prefix}-*.ckpt``, or None."""
    if not os.path.isdir(directory):
        return None
    cands = [
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if f.startswith(prefix + "-") and f.endswith(".ckpt")
    ]
    return max(cands, key=os.path.getmtime) if cands else None


def prune(directory: str, keep: int = 5, prefix: str = "slam") -> int:
    """Delete all but the newest ``keep`` checkpoints. Returns #deleted."""
    if not os.path.isdir(directory):
        return 0
    cands = sorted(
        (
            os.path.join(directory, f)
            for f in os.listdir(directory)
            if f.startswith(prefix + "-") and f.endswith(".ckpt")
        ),
        key=os.path.getmtime,
        reverse=True,
    )
    n = 0
    for p in cands[keep:]:
        os.remove(p)
        n += 1
    return n
