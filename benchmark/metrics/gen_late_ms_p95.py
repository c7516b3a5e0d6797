"""gen_late_ms_p95: 95th percentile of how late the generators published
each pair of the window against its schedule."""

from benchmark.stats import percentile


def read(run):
    p = percentile(run.gen_late_s, 95)
    return None if p is None else 1e3 * p
