"""What the readers compute: rates, percentiles over every frame, the
device's busy union and idle gaps, and B3's roofline bytes."""

import numpy as np
import pytest

from benchmark import roofline, run, trace

BENCH = run.BENCH_DIR


def reader(name):
    return run.load_reader(BENCH, name).read


def test_rate_and_percentiles_over_every_frame():
    r = run.Run(config={}, traffic={})
    r.window = (10.0, 20.0)
    r.served = 375
    r.latencies_s = list(np.arange(1, 101) / 1000.0)
    assert reader("served_fps")(r) == 37.5
    assert reader("latency_p50_ms")(r) == pytest.approx(50.5)
    assert reader("latency_p95_ms.hostpaced")(r) == pytest.approx(95.05)
    r.gen_late_s = [0.001] * 19 + [0.021]
    assert reader("gen_late_ms_p95")(r) == pytest.approx(2.0)
    r.counters = {"open": [{"frames": 10, "batches": 2}],
                  "close": [{"frames": 90, "batches": 12}]}
    assert reader("frames_per_batch")(r) == 8.0


def test_nothing_to_read_reads_nothing():
    r = run.Run(config={}, traffic={})
    for name in ("served_fps", "latency_p50_ms", "device_idle_share",
                 "sgm_aggregate_roofline", "device_ms_per_frame",
                 "launches_per_frame", "frames_per_batch",
                 "gen_late_ms_p95"):
        assert reader(name)(r) is None, name


def test_busy_union_on_synthetic_events():
    starts = np.array([0.0, 1.0, 1.5, 5.0, 9.5])
    ends = np.array([2.0, 1.2, 3.0, 6.0, 12.0])
    # [0, 3] + [5, 6] + [9.5, 10] inside [0, 10]
    assert trace.busy_union(starts, ends, 0.0, 10.0) == pytest.approx(4.5)
    assert trace.busy_union(starts, ends, 1.0, 5.5) == pytest.approx(2.5)
    gaps = trace.idle_gaps(starts, ends, list("abcde"), 0.0, 10.0)
    assert gaps == pytest.approx({"c": 2.0, "d": 3.5})


def _events(names, starts, ends):
    return trace.summarise(np.array(starts), np.array(ends), names, 0.0)


def test_summarise_needs_a_recorded_event():
    with pytest.raises(RuntimeError):
        _events([], [], [])
    tr = _events(["k", "k"], [0.5, 0.9], [0.6, 1.0])
    assert (tr.window_s, tr.markers) == (pytest.approx(0.5), 0)
    assert tr.busy_s == pytest.approx(0.2)


def test_trace_readers_on_synthetic_events():
    agg = "void sgm_aggregate_lanes_kernel<__nv_bfloat16, __nv_bfloat16, 5>"
    names = ["spin_kernel(long)", agg, "copy", agg, "spin_kernel(long)"]
    tr = _events(names, [1.0, 1.1, 1.3, 1.5, 2.9],
                 [1.01, 1.2, 1.4, 1.6, 3.0])
    assert tr.window_s == pytest.approx(2.0)
    assert tr.busy_s == pytest.approx(0.3)
    assert tr.events == 3
    r = run.Run(config={"params": {"max_disparity": 64}, "height": 1080,
                        "width": 1920}, traffic={}, device_trace=tr)
    assert reader("device_idle_share")(r) == pytest.approx(85.0)
    assert reader("device_ms_per_frame")(r) == pytest.approx(300.0)
    assert reader("launches_per_frame")(r) == pytest.approx(3.0)
    least = 2 * 65 * 1080 * 1920 * 4 / roofline.MEM_BPS
    assert reader("sgm_aggregate_roofline")(r) == pytest.approx(
        100 * least / 0.2)


@pytest.mark.parametrize("maxd,name,bound_ms", [
    (64, "void sgm_aggregate_lanes_kernel<__nv_bfloat16, __nv_bfloat16, 5>"
         "(__nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, float,"
         " float)", 0.1609),
    (64, "void sgm_aggregate_lanes_kernel<unsigned char, __nv_bfloat16, 5>"
         "(unsigned char const*, __nv_bfloat16*, int, int, int, int, float,"
         " float)", 0.1207),
    (256, "_Z25sgm_aggregate_wide_kernelI13__nv_bfloat16S0_Li16EEvPKT_PT0_"
          "iiiiiiffPi", 0.6363),
    (256, "void sgm_aggregate_wide_kernel<__nv_bfloat16, __nv_bfloat16, 16>"
          "(__nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, int,"
          " int, float, float, int*)", 0.6363),
    (256, "void sgm_aggregate_wide_kernel<unsigned char, __nv_bfloat16, 16>"
          "(unsigned char const*, __nv_bfloat16*, int, int, int, int, int,"
          " int, float, float, int*)", 0.4772),
    (256, "_Z25sgm_aggregate_wide_kernelIh13__nv_bfloat16Li16EEvPKT_PT0_"
          "iiiiiiffPi", 0.4772),
])
def test_aggregate_bounds_match_the_kernel_table(maxd, name, bound_ms):
    work = roofline.aggregate_pass(name, maxd + 1, 1080, 1920)
    seconds, by = roofline.bound_s(*work, roofline.F32_OPS)
    assert by == "bytes"
    assert round(1e3 * seconds, 4) == bound_ms


def test_other_kernels_are_not_b3():
    assert roofline.aggregate_pass("sgm_transpose_add_kernel<...>", 65, 8,
                                   8) is None


def test_a_slice_is_whole_with_kernels_over_half_of_it():
    def tr(names, starts, ends):
        return _events(names, starts, ends)
    copies = tr(["Memcpy HtoD (Pinned -> Device)"] * 2, [0.0, 3.5], [0.1, 4.0])
    assert not run.whole(copies, 4.0)
    short = tr(["k", "k"], [0.0, 1.0], [0.5, 1.5])
    assert not run.whole(short, 4.0)
    assert run.whole(tr(["k", "Memcpy DtoH"], [0.0, 2.0], [1.0, 2.5]), 4.0)
