"""latency_p95_ms.hostpaced: latency_p95_ms's number, read in the traced
run of a cell whose device idles most of the window, where the tail is
paced by the host's launches and not judged end to end."""

from benchmark.stats import percentile


def read(run):
    p = percentile(run.latencies_s, 95)
    return None if p is None else 1e3 * p
