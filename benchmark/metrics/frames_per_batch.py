"""frames_per_batch: growth of the pipelines' own ``frames`` over the
growth of their ``batches`` across the window, every rig together."""


def read(run):
    opened, closed = run.counters.get("open"), run.counters.get("close")
    if not opened or not closed:
        return None
    frames = sum(c["frames"] - o["frames"] for o, c in zip(opened, closed))
    batches = sum(c["batches"] - o["batches"]
                  for o, c in zip(opened, closed))
    if batches <= 0:
        return None
    return frames / batches
