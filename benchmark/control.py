"""The control of the comparison that decides ``correct``: the
configuration's plain reference computed in bfloat16 put in the program's
place, judged as a run judges the program's maps.

    python -m benchmark.control --workload NAME --seeds 1,2,3 [--device cuda]

For each seed it makes the cell's scenes, takes as many maps per rig as a
run compares (frame ids drawn from the seed over the frames a window of
``--seconds`` offers), computes each in bfloat16 with its colorized form,
and prints one JSON line per seed with the numbers the judge compares.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from benchmark import judge, run
from benchmark.scene import Scene, seed_sequence


def control_readings(spec: dict, name: str, seed: int, seconds: float,
                     device: torch.device, bench_dir: str = run.BENCH_DIR,
                     root: str = run.ROOT) -> dict:
    _, config, traffic = run.cell_parts(spec, name, bench_dir, root)
    reference = judge.load_reference(root, config)
    maxd = config["params"]["max_disparity"]
    rigs = int(traffic["rigs"])
    scenes = [Scene(height=config["height"], width=config["width"],
                    max_disparity=maxd, traffic=traffic, seed=seed, rig=r)
              for r in range(rigs)]
    maps = []
    for rig, scene in enumerate(scenes):
        rng = np.random.default_rng(seed_sequence(seed, 11, rig))
        offered = int(seconds * traffic["rate_hz"])
        ids = sorted(rng.choice(offered, judge.SAMPLE_PER_RIG,
                                replace=False))
        disps = reference.depth_u8([scene.pair(int(f)) for f in ids],
                                   config, device, dtype=torch.bfloat16)
        for i, (fid, disp) in enumerate(zip(ids, disps)):
            rgb = reference.colorize(disp) if i == 0 else None
            maps.append(judge.Served(rig, int(fid), disp, rgb))
    compared = judge.compare(maps, scenes, reference, config, device)
    checked = judge.checks({
        "map_px_wrong": compared["map_px_wrong"],
        "depth_px_wrong": compared["depth_px_wrong"],
        "ids_bad": sum(scenes[m.rig].band.decode(m.disp) != m.frame_id
                       for m in maps),
        "maps_repeated": 0,
        "sample_empty": 0,
    })
    return {"workload": name, "seed": seed, "correct": judge.within(checked),
            "maps_compared": compared["maps_compared"], "checks": checked}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    device = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_readings(spec, args.workload, seed,
                                          args.seconds, device)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
