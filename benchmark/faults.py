"""Faults planted under the timed path, to read what the judge makes of
them: a served cell's serve step that returns its state unchanged, that
leaves half of the batch out and puts the mean of the rest in its place,
that alters an answer where it is produced, or that never answers. (One
chip: no exchange between chips to leave out.)

    python -m benchmark.faults --workload NAME --seeds 1,2,3 [--seconds S]

runs the cell once per fault and seed, on the card, and prints one JSON
line per run with its checks. The benchmark's own runs never plant one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import torch


def _sound():
    from steroscopic_hardware_tpu_torch.models import blockmatch

    return blockmatch.sgm_serve_step


def state_unchanged(sound):
    """The serve step keeps returning the first maps it made for a batch
    of that size."""
    first = {}

    def step(stacked, **kw):
        out = sound(stacked, **kw)
        return first.setdefault(out.shape, out.clone())
    return step


def half_batch_left_out(sound):
    """Half the batch left out, the mean of the rest in its place."""
    def step(stacked, **kw):
        B = stacked.shape[0]
        if B == 1:
            return sound(stacked, **kw)
        done = sound(stacked[:B // 2], **kw)
        mean = done.to(torch.float32).mean(0, keepdim=True).round().to(
            done.dtype)
        return torch.cat([done, mean.expand(B - B // 2, *done.shape[1:])])
    return step


def answer_altered(sound):
    """One pixel of every map altered where it is produced."""
    def step(stacked, **kw):
        out = sound(stacked, **kw).clone()
        out[:, out.shape[1] // 2, out.shape[2] // 2] += 1
        return out
    return step


def no_answer(sound):
    """The serve step fails on the pipeline's threads: no map comes (the
    set-up's warm-up, on the main thread, still passes)."""
    import threading

    def step(stacked, **kw):
        if threading.current_thread() is threading.main_thread():
            return sound(stacked, **kw)
        raise RuntimeError("planted fault: no answer")
    return step


FAULTS = {"state_unchanged": state_unchanged,
          "half_batch_left_out": half_batch_left_out,
          "answer_altered": answer_altered,
          "no_answer": no_answer}


@contextlib.contextmanager
def planted(name: str):
    """The program's SGM serve step replaced by fault ``name``."""
    from steroscopic_hardware_tpu_torch.models import blockmatch

    sound = blockmatch.sgm_serve_step
    blockmatch.sgm_serve_step = FAULTS[name](sound)
    try:
        yield
    finally:
        blockmatch.sgm_serve_step = sound


def main(argv=None) -> int:
    import time

    from benchmark import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--faults", default=",".join(FAULTS))
    args = ap.parse_args(argv)
    run.cache_dirs(run.ROOT)
    spec = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    for fault in args.faults.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            with planted(fault):
                line = run.run_cell(spec, args.workload, seed, args.seconds,
                                    False, t_start=time.perf_counter())
            print(json.dumps({"workload": args.workload, "fault": fault,
                              "seed": seed, "correct": line["correct"],
                              "served": line["run"]["served"],
                              "checks": line["checks"]}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
