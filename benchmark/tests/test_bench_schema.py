"""The last line's schema: a traced run never prints a device object
without its window."""

import json

import pytest

from benchmark import schema

DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
          "memory_peak_bytes": 123}
CHECKS = {"map_px_wrong": {"value": 0, "limit": 0}}


def line(device, trace):
    return schema.result_line(
        correct=True, attempted=3, failed=0,
        metrics={"served_fps": {"value": 1.5, "unit": "frames/s"}},
        device=device, trace=trace, checks=CHECKS,
        breakdown={"device_ops": [], "idle_gaps": []} if trace else None,
        info={"served": 2})


@pytest.mark.parametrize("extra", [
    {}, {"busy_s": 1.0}, {"window_s": 2.0}, {"busy_s": 0.0, "window_s": 2.0},
    {"busy_s": 2.5, "window_s": 2.0}, {"busy_s": None, "window_s": 2.0},
    {"busy_s": float("nan"), "window_s": 2.0},
])
def test_traced_line_refuses_a_device_without_its_window(extra):
    with pytest.raises(schema.SchemaError):
        line(dict(DEVICE, **extra), trace=True)


def test_traced_line_with_its_window():
    out = line(dict(DEVICE, busy_s=1.0, window_s=2.0), trace=True)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "run", "checks"]
    json.dumps(out)


def test_untraced_line_and_missing_device_keys():
    assert list(line(DEVICE, trace=False))[-1] == "checks"
    bad = dict(DEVICE)
    del bad["memory_peak_bytes"]
    with pytest.raises(schema.SchemaError):
        line(bad, trace=False)
