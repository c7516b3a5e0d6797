"""The result line, built from a fixed schema and checked before it is
printed: a line that would lack a required key is never printed."""

from __future__ import annotations

import math

DEVICE_KEYS = ("platform", "kind", "count", "memory_peak_bytes")


class SchemaError(ValueError):
    """A result that may not be printed."""


def _number(x) -> bool:
    return (isinstance(x, (int, float)) and not isinstance(x, bool)
            and math.isfinite(x))


def check_device(device: dict, trace: bool) -> None:
    missing = [k for k in DEVICE_KEYS if k not in device]
    if missing:
        raise SchemaError(f"device lacks {', '.join(missing)}")
    if not trace:
        return
    busy, window = device.get("busy_s"), device.get("window_s")
    if not (_number(busy) and _number(window)):
        raise SchemaError(f"a traced run needs device.busy_s and "
                          f"device.window_s as numbers, got busy_s={busy!r} "
                          f"window_s={window!r}")
    if not 0 < busy <= window:
        raise SchemaError(f"device.busy_s {busy} is not in (0, window_s "
                          f"{window}]")


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, trace: bool, checks: dict,
                breakdown: dict | None = None,
                info: dict | None = None) -> dict:
    """The result as an ordered dict: ``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, [``breakdown``], [``run``], and
    ``checks`` last. Raises :class:`SchemaError` where it is incomplete."""
    check_device(device, trace)
    for name, m in metrics.items():
        if set(m) != {"value", "unit"} or not _number(m["value"]):
            raise SchemaError(f"metric {name} is not a value and a unit")
    for name, c in checks.items():
        if not (_number(c.get("value")) and _number(c.get("limit"))):
            raise SchemaError(f"check {name} lacks its value or limit")
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    if info is not None:
        line["run"] = info
    line["checks"] = checks
    return line
