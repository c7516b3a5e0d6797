"""The port's ``utils/checkpoint.py`` (a numpy copy of the JAX module): the
round trip, corruption detection, ``latest`` and ``prune``, as
``tests/test_checkpoint_slam.py`` holds the JAX one, and archives that each
package writes and the other reads."""

import time

import numpy as np
import pytest

from steroscopic_hardware_tpu.utils import checkpoint as jckpt
from steroscopic_hardware_tpu_torch.utils import checkpoint as ckpt


def _arrays(rng):
    return {"a": rng.normal(0, 1, (8, 3)).astype(np.float32),
            "b": rng.integers(0, 255, (4, 4), dtype=np.uint8)}


@pytest.mark.parametrize("writer,reader", [
    (ckpt, ckpt), (ckpt, jckpt), (jckpt, ckpt)])
def test_checkpoint_roundtrip(writer, reader, tmp_path, rng):
    arrays = _arrays(rng)
    path = str(tmp_path / "x.ckpt")
    man = writer.save(path, arrays, {"note": "hi"})
    assert man["meta"]["note"] == "hi"
    assert man["format_version"] == ckpt.FORMAT_VERSION
    loaded, man2 = reader.load(path)
    assert man2["sha256"] == man["sha256"]
    assert set(loaded) == set(arrays)
    for k in arrays:
        assert np.array_equal(loaded[k], arrays[k])
        assert loaded[k].dtype == arrays[k].dtype


def test_checkpoint_corruption_detected(tmp_path):
    path = str(tmp_path / "x.ckpt")
    ckpt.save(path, {"a": np.zeros(4)})
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF  # a byte inside the payload
    open(path, "wb").write(bytes(blob))
    with pytest.raises(Exception):
        ckpt.load(path)


def test_checkpoint_checksum_and_version_checked(tmp_path, monkeypatch):
    path = str(tmp_path / "x.ckpt")
    ckpt.save(path, {"a": np.arange(4)})
    # a manifest whose checksum does not match its payload
    real = ckpt.hashlib.sha256

    class Wrong:
        def __init__(self, data):
            pass

        def hexdigest(self):
            return "0" * 64

    monkeypatch.setattr(ckpt.hashlib, "sha256", Wrong)
    with pytest.raises(ckpt.CorruptCheckpoint, match="checksum"):
        ckpt.load(path)
    monkeypatch.setattr(ckpt.hashlib, "sha256", real)
    monkeypatch.setattr(ckpt, "FORMAT_VERSION", 99)
    with pytest.raises(ckpt.CorruptCheckpoint, match="unsupported"):
        ckpt.load(path)


def test_checkpoint_latest_and_prune(tmp_path):
    assert ckpt.latest(str(tmp_path / "missing")) is None
    assert ckpt.prune(str(tmp_path / "missing")) == 0
    for i in range(7):
        ckpt.save(str(tmp_path / f"slam-{i}.ckpt"), {"i": np.array([i])})
        time.sleep(0.01)
    (tmp_path / "other-9.ckpt").write_bytes(b"")  # another prefix
    assert ckpt.latest(str(tmp_path)).endswith("slam-6.ckpt")
    assert ckpt.prune(str(tmp_path), keep=3) == 4
    assert ckpt.latest(str(tmp_path)).endswith("slam-6.ckpt")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "other-9.ckpt", "slam-4.ckpt", "slam-5.ckpt", "slam-6.ckpt"]
