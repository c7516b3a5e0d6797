"""The port's golden-vector generator (``tools/gen_vectors.py``) against
the JAX package's on the CPU: on a seeded PNG pair written with the port's
``io/png``, the files the port writes (patches, hex vectors, PGMs) are
byte-equal to those of ``tools/gen_vectors.py`` run as a subprocess with
``JAX_PLATFORMS=cpu``; and ``serve_probe`` takes serve_bench's last two
rows as modes of its own.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from steroscopic_hardware_tpu_torch import serve_probe
from steroscopic_hardware_tpu_torch.io.png import write_png
from steroscopic_hardware_tpu_torch.tools import gen_vectors

ROOT = Path(__file__).resolve().parent.parent


def _pair(seed, shape=(120, 160), shift=5):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, shape, dtype=np.uint8)
    right = np.clip(np.roll(left, -shift, axis=1).astype(int)
                    + rng.integers(-3, 4, shape), 0, 255).astype(np.uint8)
    return left, right


def _files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("seed,flags", [
    (0, ["--n", "3", "--size", "48", "--block", "7", "--disp", "16"]),
    (7, ["--n", "2", "--size", "64", "--seed", "9"]),   # block 15, disp 64
])
def test_files_equal_the_original(tmp_path, seed, flags):
    left, right = _pair(seed)
    paths = [str(tmp_path / n) for n in ("L.png", "R.png")]
    write_png(paths[0], left)
    write_png(paths[1], right)
    io = ["--left", paths[0], "--right", paths[1], *flags]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "gen_vectors.py"),
         str(tmp_path / "jax"), *io], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert gen_vectors.main([str(tmp_path / "port"), *io]) == 0
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    n = int(flags[1])
    assert len(got) == 4 * n and sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def _serve_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_serve_bench", ROOT / "tools" / "serve_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_probe_takes_the_last_two_rows(monkeypatch, capsys):
    """``--modes device-colorize-preview-2,slam-sgm-half`` boots the server
    with serve_bench's ``sad-dev-light2`` and ``slam-1080p`` flags (less the
    latter's testdata pair and its fixed centre: the probe serves its own
    pair and puts --cx / --cy at the frame's centre), the SLAM row waiting
    for the warm backend."""
    configs = _serve_bench().CONFIGS
    calls = []

    def fake(argv, seconds, **kw):
        calls.append((argv, kw))
        return {"frames": 1, "errors": 0}

    monkeypatch.setattr(serve_probe, "probe_mode", fake)
    assert serve_probe.main([
        "--device", "cpu", "--height", "16", "--width", "40", "--modes",
        "device-colorize-preview-2,slam-sgm-half", "--seconds", "0"]) == 0
    (argv_dev, kw_dev), (argv_slam, kw_slam) = calls
    assert kw_dev == {} and kw_slam == {"slam": True}
    dev_flags = configs["sad-dev-light2"][0]
    assert argv_dev[argv_dev.index("--fps") + 2:][:len(dev_flags)] == \
        dev_flags
    slam = configs["slam-1080p"][0]
    want = slam[4:slam.index("--cx")]
    assert want == ["--slam", "--loop-closure", "--slam-frontend",
                    "sgm_half"]
    assert argv_slam[argv_slam.index("--fps") + 2:][:len(want)] == want
    assert argv_slam[-4:] == ["--cx", "20.0", "--cy", "8.0"]
    rows = capsys.readouterr().out.strip().splitlines()[1:]
    assert len(rows) == 2
