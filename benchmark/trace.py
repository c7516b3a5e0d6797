"""The device trace of a traced run, and the arithmetic read from it.

``torch.profiler`` traces CUDA activity only (no shapes, stacks or memory)
over a fixed slice at the end of the measured window, so that even the
busiest cell's slice stays far below the profiler's activity buffers and
the profiler's stop falls after the window. Two marker kernels
(``torch.cuda._sleep`` on a side stream, which the program never
launches) open and close the slice on the device. ``window_s`` is
the slice as the device recorded it, from the first recorded start to the
last recorded end: the profiler may begin recording some time after its
start returns, and what it did not record is neither busy nor idle here.
``busy_s`` is the union of every kernel, copy and memset interval inside
it, worked out from the raw events in one pass after a sort.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

MARKER = "spin_kernel"
MARKER_CYCLES = 1000
# names of device activity that is not work (waits recorded on a stream)
_NOT_WORK = ("Sync", "Wait")


@dataclasses.dataclass
class TraceResult:
    window_s: float          # device time between the two markers
    busy_s: float            # union of device intervals inside it
    events: int              # kernels, copies and memsets inside it
    markers: int             # marker kernels recorded (2 where all were)
    by_name: dict            # name -> [seconds, launches] inside it
    gaps_after: dict         # name -> idle seconds that follow it
    post_s: float            # seconds the reading took


def busy_union(starts: np.ndarray, ends: np.ndarray, lo: float,
               hi: float) -> float:
    """Length of the union of the intervals [start, end) clipped to
    [lo, hi]."""
    s = np.clip(starts, lo, hi)
    e = np.clip(ends, lo, hi)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    # the furthest end reached by the intervals before each one
    reach = np.maximum.accumulate(np.concatenate([[lo], e[:-1]]))
    return float(np.maximum(0.0, e - np.maximum(s, reach)).sum())


def idle_gaps(starts: np.ndarray, ends: np.ndarray, names: list,
              lo: float, hi: float) -> dict:
    """Idle time inside [lo, hi], charged to the device operation whose
    end opens each gap (``"window start"`` for the first)."""
    order = np.argsort(starts, kind="stable")
    gaps: dict = {}
    reach, last = lo, "window start"
    for i in order:
        s, e = max(starts[i], lo), min(ends[i], hi)
        if e <= s:
            continue
        if s > reach:
            gaps[last] = gaps.get(last, 0.0) + (s - reach)
        if e > reach:
            reach, last = e, names[i]
    if hi > reach:
        gaps[last] = gaps.get(last, 0.0) + (hi - reach)
    return gaps


def _ns(event, what: str) -> float:
    f = getattr(event, f"{what}_ns", None)
    if f is not None:
        return float(f())
    return 1e3 * float(getattr(event, f"{what}_us")())


def read_events(events) -> tuple[np.ndarray, np.ndarray, list]:
    """(starts, ends, names) in seconds of the device events of a kineto
    event list."""
    from torch.autograd import DeviceType

    starts, ends, names = [], [], []
    for ev in events:
        if ev.device_type() != DeviceType.CUDA:
            continue
        name = ev.name()
        if any(w in name for w in _NOT_WORK) and "kernel" not in name:
            continue
        start = _ns(ev, "start")
        starts.append(start)
        ends.append(start + _ns(ev, "duration"))
        names.append(name)
    return (np.asarray(starts, np.float64) * 1e-9,
            np.asarray(ends, np.float64) * 1e-9, names)


def summarise(starts, ends, names, t_read) -> TraceResult:
    """The slice as the device recorded it: from the first recorded start
    to the last recorded end (the markers' among them), and what ran
    inside it. Raises where nothing was recorded."""
    if len(names) == 0:
        raise RuntimeError("the trace holds no device event: no device "
                           "window")
    lo, hi = float(starts.min()), float(ends.max())
    work = np.array([MARKER not in n for n in names], bool)
    s, e = starts[work], ends[work]
    kept = [n for n, w in zip(names, work) if w]
    by_name: dict = {}
    for i in range(len(kept)):
        row = by_name.setdefault(kept[i], [0.0, 0])
        row[0] += e[i] - s[i]
        row[1] += 1
    return TraceResult(
        window_s=hi - lo,
        busy_s=busy_union(s, e, lo, hi),
        events=len(kept),
        markers=int((~work).sum()),
        by_name=by_name,
        gaps_after=idle_gaps(s, e, kept, lo, hi),
        post_s=time.perf_counter() - t_read,
    )


class DeviceTrace:
    """Traces one slice of the window on ``device``: ``start()`` and
    ``stop()`` inside the window, ``read() -> TraceResult`` once it has
    closed. ``warm()`` pays the profiler's first start in set-up."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.device = device
        self.side = torch.cuda.Stream(device)
        self.prof = None
        self.stop_s = None

    def _mark(self) -> None:
        torch = self.torch
        with torch.cuda.stream(self.side):
            torch.cuda._sleep(MARKER_CYCLES)

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA],
                       record_shapes=False, profile_memory=False,
                       with_stack=False, with_flops=False,
                       with_modules=False)

    def warm(self) -> None:
        prof = self._profiler()
        prof.start()
        self._mark()
        self.side.synchronize()
        prof.stop()

    def start(self, locks=()) -> None:
        """Opens the slice. ``locks`` are the program's launch locks: held
        while the profiler starts, with the device drained, so that no
        launch races its start (a start during launches has left whole
        slices without a kernel record)."""
        held = [lk for lk in locks if lk.acquire(timeout=10.0)]
        try:
            self.torch.cuda.synchronize(self.device)
            self.prof = self._profiler()
            self.prof.start()
            self._mark()
        finally:
            for lk in held:
                lk.release()

    def stop(self) -> None:
        """Closes the slice: the end marker, a wait for the device to
        finish what was launched before it, and the profiler's stop."""
        h1 = time.perf_counter()
        self._mark()
        self.side.synchronize()
        self.torch.cuda.synchronize(self.device)
        self.prof.stop()
        self.stop_s = time.perf_counter() - h1

    def read(self) -> TraceResult:
        t_read = time.perf_counter()
        events = self.prof.profiler.kineto_results.events()
        starts, ends, names = read_events(events)
        del events
        self.prof = None
        return summarise(starts, ends, names, t_read)
