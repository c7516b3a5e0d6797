"""The traffic: seeded stereo scenes whose pairs carry their frame id, and
the open-loop generator that publishes them on the app's bus.

A rig's scene is a wide textured canvas of slanted planes whose disparities
span 0..maxD. Frame ``k`` is a crop of it, panned a few pixels a frame back
and forth, so every pair differs from the one before. The top ``band_rows`` rows of every
pair are an id band: the right band is one of two fixed textures, by the
parity of ``k``, and the left band copies it shifted per tile by one of two
disparities (a quarter or three quarters of maxD), one tile per bit of
``k & 0xFFFF`` and of its complement. The served map therefore carries the
frame id of the pair it was computed from, which :meth:`IdBand.decode`
reads back; a read whose two halves are not complements is no id. A map
matched on a torn pair, the left image of one frame with the right image
of the next, reads its left band against the other texture: no id.

Everything here is numpy on the host and depends only on the seed, the rig
index, the configuration and the traffic file.
"""

from __future__ import annotations

import threading
import time

import numpy as np

ID_BITS = 16
ID_MASK = (1 << ID_BITS) - 1
TILES = 2 * ID_BITS


def seed_sequence(seed: int, *keys: int) -> np.random.SeedSequence:
    """A seed sequence for any whole ``seed`` (negative and wider than 32
    bits too) and further non-negative keys."""
    return np.random.SeedSequence([seed % (1 << 64), *keys])


class IdBand:
    """Geometry of the id band for an (H, W) pair at ``max_disparity``
    with tiles of ``tile`` pixels."""

    def __init__(self, height: int, width: int, max_disparity: int,
                 tile: int):
        self.tile = tile
        self.margin = tile // 3
        self.rows = tile + 2 * self.margin
        self.x0 = max_disparity + tile
        if self.x0 + TILES * tile > width or self.rows >= height:
            raise ValueError(
                f"an id band of {TILES} tiles of {tile} px at maxD "
                f"{max_disparity} does not fit a {height}x{width} frame")
        self.max_disparity = max_disparity
        self.disparities = (round(0.25 * max_disparity),
                            round(0.75 * max_disparity))
        # the decoded patch: the central third of each tile
        q = max(1, tile // 6)
        mid = self.margin + tile // 2
        self._r0, self._r1 = mid - q, mid + q
        centres = self.x0 + tile * np.arange(TILES) + tile // 2
        self._cols = (centres[:, None] + np.arange(-q, q)[None, :]).ravel()
        self._q2 = 2 * q

    @staticmethod
    def bits(frame_id: int) -> np.ndarray:
        v = frame_id & ID_MASK
        word = v | ((~v & ID_MASK) << ID_BITS)
        return (word >> np.arange(TILES)) & 1

    def decode(self, disp_u8: np.ndarray) -> int | None:
        """The frame id a served uint8 map carries, or None where its two
        halves are not complements."""
        patch = disp_u8[self._r0:self._r1, self._cols]
        means = patch.reshape(patch.shape[0], TILES, self._q2).mean(
            axis=(0, 2))
        bits = (means > 127.5).astype(np.int64)
        word = int((bits << np.arange(TILES)).sum())
        v, comp = word & ID_MASK, word >> ID_BITS
        return v if (v ^ comp) == ID_MASK else None


def _shifted(band: np.ndarray, d: int) -> np.ndarray:
    """``band[:, max(x - d, 0)]`` for every column x."""
    cols = np.maximum(np.arange(band.shape[1]) - d, 0)
    return band[:, cols]


class Scene:
    """One rig's seeded scene (see the module docstring)."""

    def __init__(self, *, height: int, width: int, max_disparity: int,
                 traffic: dict, seed: int, rig: int):
        rng = np.random.default_rng(seed_sequence(seed, rig))
        self.height, self.width = height, width
        self.band = IdBand(height, width, max_disparity,
                           traffic["id_tile_px"])
        self.pan_px = int(traffic["pan_px_per_frame"])
        self.pan_frames = int(traffic["pan_frames"])
        wide = width + self.pan_px * self.pan_frames
        H, maxd = height, float(max_disparity)
        texture = rng.integers(0, 256, (H, wide + 2)).astype(np.float32)
        texture = (texture[:, :-2] + 2 * texture[:, 1:-1]
                   + texture[:, 2:]) / 4
        y = np.arange(H, dtype=np.float32)[:, None]
        x = np.arange(wide, dtype=np.float32)[None, :]
        # a receding ground plane, then planes painted far to near
        disp = np.broadcast_to(
            maxd * (0.02 + 0.48 * y / H), (H, wide)).copy()
        n = int(traffic["planes"])
        bases = rng.permutation(np.linspace(0.0, maxd, n))
        for base in np.sort(bases):
            h = int(rng.integers(H // 8, H // 3 + 1))
            w = int(rng.integers(width // 10, width // 4 + 1))
            y0 = int(rng.integers(0, H - h + 1))
            x0 = int(rng.integers(0, wide - w + 1))
            gx, gy = rng.uniform(-0.01, 0.01, 2) * maxd / 16
            yc, xc = y0 + h / 2, x0 + w / 2
            plane = (base + gx * (x[:, x0:x0 + w] - xc)
                     + gy * (y[y0:y0 + h] - yc))
            disp[y0:y0 + h, x0:x0 + w] = np.clip(plane, 0.0, maxd)
        # left(y, x) = right texture at x - d(y, x), linearly interpolated
        src = np.maximum(x - disp, 0.0)
        i0 = np.minimum(np.floor(src).astype(np.int64), wide - 2)
        f = src - i0
        rows = np.arange(H)[:, None]
        left = texture[rows, i0] * (1 - f) + texture[rows, i0 + 1] * f
        self._left = np.clip(np.rint(left), 0, 255).astype(np.uint8)
        self._right = np.clip(np.rint(texture), 0, 255).astype(np.uint8)
        b = self.band
        self._right_bands = [rng.integers(0, 256, (b.rows, width),
                                          dtype=np.uint8) for _ in range(2)]
        self._left_bands = [(_shifted(rb, b.disparities[0]),
                             _shifted(rb, b.disparities[1]))
                            for rb in self._right_bands]

    def offset(self, k: int) -> int:
        """Pan of frame ``k``: back and forth over ``pan_frames`` frames."""
        p = self.pan_frames
        t = k % (2 * p) if p else 0
        return self.pan_px * (t if t <= p else 2 * p - t)

    def band_into(self, k: int, left: np.ndarray,
                  right: np.ndarray) -> None:
        """Write the id bands of pair ``k``."""
        b = self.band
        right[:b.rows] = self._right_bands[k % 2]
        lo, hi = self._left_bands[k % 2]
        left[:b.rows] = lo
        t, r0 = b.tile, b.margin
        for i, bit in enumerate(IdBand.bits(k)):
            if bit:
                c = b.x0 + i * t
                left[r0:r0 + t, c:c + t] = hi[r0:r0 + t, c:c + t]

    def pair_into(self, k: int, left: np.ndarray, right: np.ndarray) -> None:
        """Write pair ``k`` into the (H, W) uint8 arrays given."""
        b, W = self.band, self.width
        off = self.offset(k)
        left[b.rows:] = self._left[b.rows:, off:off + W]
        right[b.rows:] = self._right[b.rows:, off:off + W]
        self.band_into(k, left, right)

    def pair(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        left = np.empty((self.height, self.width), np.uint8)
        right = np.empty_like(left)
        self.pair_into(k, left, right)
        return left, right

    def period(self) -> int:
        """Frames after which the pan, and so the pair but its id band,
        repeats."""
        return max(1, 2 * self.pan_frames)


class Generator:
    """Publishes one rig's pairs on the bus in an open loop: pair ``k`` is
    due at ``t0 + phase_s + k / rate_hz`` (``time.perf_counter`` seconds),
    whatever the server does, right image first, then left. A pool of
    whole periods of the pan, at least ``hold_s`` long, is rendered in
    set-up; pair ``k`` is pool entry ``k`` modulo its length with the id
    bands of ``k`` written into it, so that publishing costs the bands
    and two bus calls, and a pair's buffer is not written again for
    ``hold_s``. ``records`` holds (k, due, published) per pair."""

    def __init__(self, bus, scene: Scene, *, left_slot: str,
                 right_slot: str, rate_hz: float, phase_s: float,
                 hold_s: float):
        self.bus, self.scene = bus, scene
        self.left_slot, self.right_slot = left_slot, right_slot
        self.rate_hz, self.phase_s = float(rate_hz), float(phase_s)
        period = scene.period()
        n = period * max(1, -(-int(hold_s * rate_hz) // period))
        self.pool = np.empty((n, 2, scene.height, scene.width), np.uint8)
        for k in range(n):
            scene.pair_into(k, self.pool[k, 0], self.pool[k, 1])
        self.records: list[tuple[int, float, float]] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.t0 = None

    def due(self, k: int) -> float:
        return self.t0 + self.phase_s + k / self.rate_hz

    def start(self, t0: float) -> None:
        self.t0 = t0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"gen-{self.left_slot}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(10.0)
            if self._thread.is_alive():
                raise RuntimeError("generator thread did not stop")

    def _run(self) -> None:
        pool, n = self.pool, len(self.pool)
        k = 0
        while True:
            wait = self.due(k) - time.perf_counter()
            if (wait > 0 and self._stop.wait(wait)) or self._stop.is_set():
                return
            s = k % n
            self.bus.publish(self.right_slot, pool[s, 1], source="benchmark")
            self.bus.publish(self.left_slot, pool[s, 0], source="benchmark")
            self.records.append((k, self.due(k), time.perf_counter()))
            k += 1
            self.scene.band_into(k, pool[k % n, 0], pool[k % n, 1])
