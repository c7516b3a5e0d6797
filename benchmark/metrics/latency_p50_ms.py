"""latency_p50_ms: median, over every map served in the window on every
rig, of the time from the moment its pair was due at the generator to the
moment the map was published on the bus."""

from benchmark.stats import percentile


def read(run):
    p = percentile(run.latencies_s, 50)
    return None if p is None else 1e3 * p
