"""What decides ``correct``: the served maps against the plain reference.

Every map a rig published in the window must carry a readable frame id
(``ids_bad``): the id band of its left image read against the right band
of the same pair, so a map matched on a pair torn across two frames reads
no id. No rig may serve a frame id twice (``maps_repeated``, a count). A
sample of the maps, drawn from the seed among those the keep rule copied
as they were published, is recomputed by the plain reference from the pair
the generator handed over and compared pixel for pixel: the uint8 map
(``map_px_wrong``) and, where the pipeline colorized that map for the
``depth`` slot, the RGB map (``depth_px_wrong``). A rig with no compared
map or no compared depth map counts in ``sample_empty``.

The reference is the module at the path a configuration names under
``"reference"`` (relative to the checkout's root). It offers
``depth_u8(pairs, config, device, dtype=torch.float32)``, the served maps
of a list of (left, right) pairs, and ``colorize(disp_u8)``, the RGB map.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os

import numpy as np
from benchmark.scene import seed_sequence

# name -> limit; see PERF.md for the readings each limit was set from
LIMITS = {
    "map_px_wrong": 0,
    "depth_px_wrong": 0,
    "ids_bad": 0,
    "maps_repeated": 0,
    "sample_empty": 0,
}
SAMPLE_PER_RIG = 24


def load_reference(root: str, config: dict):
    """The reference module the configuration names."""
    path = os.path.join(root, config["reference"])
    name = "benchmark_reference_" + os.path.splitext(
        os.path.basename(path))[0].replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Served:
    """One map as served: its rig, frame id, the uint8 map and its RGB
    form (None where the pipeline colorized another map of the batch)."""
    rig: int
    frame_id: int
    disp: np.ndarray
    rgb: np.ndarray | None


def draw_sample(kept: dict, rigs: int, seed: int,
                per_rig: int = SAMPLE_PER_RIG) -> list:
    """Keys (rig, frame_id) of ``kept`` drawn from the seed: ``per_rig``
    maps of each rig, and one more that has its RGB map where none drawn
    has."""
    chosen = []
    for rig in range(rigs):
        rng = np.random.default_rng(seed_sequence(seed, 7, rig))
        ids = sorted(fid for r, fid in kept if r == rig)
        pick = [ids[i] for i in sorted(
            rng.choice(len(ids), min(per_rig, len(ids)), replace=False))]
        if not any(kept[(rig, f)].rgb is not None for f in pick):
            with_rgb = [f for f in ids
                        if kept[(rig, f)].rgb is not None and f not in pick]
            if with_rgb:
                pick.append(with_rgb[int(rng.integers(len(with_rgb)))])
        chosen += [(rig, f) for f in pick]
    return chosen


def compare(maps: list, scenes: list, reference, config: dict,
            device) -> dict:
    """Pixels by which each served map and its RGB form differ from the
    reference of its pair: {"map_px_wrong", "depth_px_wrong",
    "maps_wrong", "maps_compared", "depth_compared"}."""
    refs = reference.depth_u8(
        [scenes[m.rig].pair(m.frame_id) for m in maps], config, device)
    out = dict(map_px_wrong=0, depth_px_wrong=0, maps_wrong=0,
               maps_compared=0, depth_compared=0)
    for m, ref in zip(maps, refs):
        wrong = int(np.count_nonzero(ref != m.disp))
        out["maps_compared"] += 1
        out["map_px_wrong"] += wrong
        bad = wrong > 0
        if m.rgb is not None:
            rgb_wrong = int(np.count_nonzero(
                (reference.colorize(ref) != m.rgb).any(axis=-1)))
            out["depth_px_wrong"] += rgb_wrong
            out["depth_compared"] += 1
            bad = bad or rgb_wrong > 0
        out["maps_wrong"] += int(bad)
    return out


def checks(values: dict) -> dict:
    """{name: {"value", "limit"}} in the order of ``LIMITS``."""
    return {name: {"value": values[name], "limit": limit}
            for name, limit in LIMITS.items()}


def within(checked: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checked.values())
