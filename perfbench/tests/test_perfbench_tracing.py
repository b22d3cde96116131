"""The reduction of a Chrome trace: the stretch, the device's busy time
(operations merged), the top operations and the idle gaps named by the
innermost host operation running in them."""
import pytest

from perfbench import tracing


def _x(cat, name, ts, dur, **kw):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, **kw}


EVENTS = [
    {"ph": "M", "name": "process_name", "pid": 1, "args": {}},
    _x("user_annotation", tracing.MARK, 100.0, 100.0),
    _x("cpu_op", "aten::add", 105.0, 20.0),
    _x("cuda_runtime", "cudaLaunchKernel", 110.0, 5.0),
    _x("kernel", "k1_df_kernel", 120.0, 30.0),
    _x("kernel", "k2_df_kernel", 140.0, 20.0),       # overlaps k1
    _x("gpu_memcpy", "Memcpy DtoH", 170.0, 10.0),
    _x("cpu_op", "aten::item", 150.0, 35.0),
    _x("kernel", "outside", 300.0, 10.0),            # after the stretch
    {"ph": "f", "cat": None, "name": "ac2g", "ts": 120.0},
]


def test_busy_time_window_and_operations():
    tr = tracing.read(EVENTS)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(50e-6)     # [120, 160) + [170, 180)
    assert [n for n, _ in tr.device_ops()] == ["k1_df_kernel",
                                               "k2_df_kernel", "Memcpy DtoH"]


def test_idle_gaps_by_host_operation():
    tr = tracing.read(EVENTS)
    gaps = dict(tr.idle_gaps())
    # [100, 120): aten::add covers its midpoint 110 (cudaLaunchKernel
    # ends at 115 and starts at 110: the innermost is the launch)
    assert gaps["cudaLaunchKernel"] == pytest.approx(20e-6)
    assert gaps["aten::item"] == pytest.approx(10e-6)   # [160, 170)
    # [180, 200): midpoint 190 is past aten::item's end
    assert gaps["host code between traced operations"] == pytest.approx(
        20e-6)


def test_without_a_mark_the_stretch_is_the_span_of_its_events():
    tr = tracing.read([e for e in EVENTS if e.get("name") != tracing.MARK])
    assert tr.window_s == pytest.approx((310.0 - 105.0) * 1e-6)
    assert tracing.read([]) is None


def test_busy_time_of_overlapping_spans():
    assert tracing.busy_ns([(5, 9), (0, 2), (1, 3), (9, 10)]) == 8
    assert tracing.busy_ns([]) == 0
