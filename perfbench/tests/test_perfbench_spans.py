"""The program's spans in a host-and-card trace (perfbench/spans.py): the
card's idle time split exactly by the innermost program span, nested
spans, the counts of syncs and iterations, the readers of a run, and
tracing.read's readings left as they were."""
import copy
import json
import os

import pytest

from perfbench import spans, spec, tracing
from perfbench.harness import Record
from perfbench.tests.test_perfbench_tracing import EVENTS as OLD_EVENTS


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _u(name, ts, dur):
    return _x("user_annotation", name, ts, dur)


EVENTS = [
    _u(tracing.MARK, 100.0, 100.0),
    _u("mbt.sync", 90.0, 5.0),                    # before the stretch
    _u("mbt.iter", 100.0, 80.0),
    _u("mbt.launch.fused_k1_df", 105.0, 10.0),
    _x("cpu_op", "aten::empty", 106.0, 2.0),
    _u("mbt.sync", 150.0, 25.0),
    _x("cpu_op", "aten::item", 151.0, 20.0),
    # after the iteration; torch's C++ range records a cpu_op
    _x("cpu_op", "mbt.launch.dia_spmv_df", 185.0, 10.0),
    _x("kernel", "k1_df_kernel", 112.0, 18.0),
    _x("kernel", "k2_df_kernel", 140.0, 20.0),
    _x("gpu_memcpy", "Memcpy DtoH", 170.0, 2.0),
    _x("gpu_user_annotation", "mbt.iter", 112.0, 60.0),
    _x("kernel", "outside", 300.0, 10.0),
]
# idle [100, 112) [130, 140) [160, 170) [172, 200), split by span:
SPLIT = {"mbt.iter": 5.0 + 10.0 + 5.0, "mbt.launch.fused_k1_df": 7.0,
         "mbt.sync": 10.0 + 3.0, spans.OUTSIDE: 5.0 + 5.0,
         "mbt.launch.dia_spmv_df": 10.0}


def test_the_idle_time_is_split_exactly():
    sp = spans.read(EVENTS)
    tr = tracing.read(EVENTS)
    assert sp.idle_s == pytest.approx(tr.window_s - tr.busy_s, abs=1e-15)
    assert set(sp.idle_by_span) == set(SPLIT)
    for name, us in SPLIT.items():
        assert sp.idle_by_span[name] == pytest.approx(us * 1e-6)
    assert sp.idle_launch_s == pytest.approx(17e-6)
    assert sp.idle_loop_s == pytest.approx(33e-6)   # iter and sync in it
    assert sp.idle_launch_s + sp.idle_loop_s <= sp.idle_s


def test_nested_spans_give_the_time_to_the_innermost():
    events = [_u(tracing.MARK, 0.0, 100.0),
              _u("mbt.solve", 0.0, 100.0),
              _u("mbt.iter", 10.0, 80.0),
              _u("mbt.spmv", 20.0, 40.0),
              _u("mbt.launch.dia_spmv", 30.0, 10.0),
              _x("kernel", "k", 50.0, 10.0)]
    sp = spans.read(events)
    assert sp.idle_by_span == pytest.approx({
        "mbt.solve": 20e-6, "mbt.iter": 40e-6, "mbt.spmv": 20e-6,
        "mbt.launch.dia_spmv": 10e-6})
    assert sp.idle_launch_s == pytest.approx(10e-6)
    assert sp.idle_loop_s == pytest.approx(60e-6)


def test_syncs_and_iterations_are_counted_in_the_stretch():
    sp = spans.read(EVENTS)
    assert sp.count("mbt.sync") == 1 and sp.count("mbt.iter") == 1
    assert sp.count("mbt.launch.dia_spmv_df") == 1
    assert spans.read([e for e in EVENTS
                       if e["name"] != tracing.MARK]) is None


def test_tracing_read_is_left_as_it_was():
    before = copy.deepcopy(OLD_EVENTS)
    assert spans.read(OLD_EVENTS).spans == []
    assert OLD_EVENTS == before
    old = tracing.read(OLD_EVENTS)
    assert (old.window_s, old.busy_s) == (pytest.approx(100e-6),
                                          pytest.approx(50e-6))
    # program spans name idle gaps but move no device reading
    with_spans = tracing.read(EVENTS)
    without = tracing.read([e for e in EVENTS
                            if not e["name"].startswith("mbt.")])
    assert (with_spans.window_s, with_spans.busy_s, with_spans.device) == \
        (without.window_s, without.busy_s, without.device)


def _record(tmp_path, monkeypatch, events, name="cell.1.json"):
    """A run whose stretch wrote `events` as the newest trace."""
    monkeypatch.setattr("perfbench.harness.TRACE_DIR", tmp_path)
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    t = 10**18 + len(list(tmp_path.iterdir()))
    os.utime(path, ns=(t, t))
    return Record(trace_host=tracing.read(events))


def test_the_readers_of_a_run(tmp_path, monkeypatch):
    run = _record(tmp_path, monkeypatch, EVENTS)
    syncs = spec.reader("host_syncs_per_iter").read
    launch = spec.reader("idle_launch_pct").read
    loop = spec.reader("idle_loop_pct").read
    assert syncs(run) == 1.0
    assert launch(run) == pytest.approx(100.0 * 17 / 60)
    assert loop(run) == pytest.approx(100.0 * 33 / 60)
    for m in ("host_syncs_per_iter", "idle_launch_pct", "idle_loop_pct"):
        assert spec.reader(m + ".dev").read(run) == spec.reader(m).read(run)


def test_readers_report_nothing_without_spans_or_a_card(tmp_path,
                                                        monkeypatch):
    names = ("host_syncs_per_iter", "idle_launch_pct", "idle_loop_pct")
    # a program older than its spans
    plain = [e for e in EVENTS if not e["name"].startswith("mbt.")]
    run = _record(tmp_path, monkeypatch, plain)
    assert [spec.reader(m).read(run) for m in names] == [None] * 3
    # no operation of a card: the spans are counted, no idle share
    host = [e for e in EVENTS if e["cat"] not in tracing.DEVICE_CATS]
    run = _record(tmp_path, monkeypatch, host, "other.1.json")
    assert spec.reader("host_syncs_per_iter").read(run) == 1.0
    assert spec.reader("idle_launch_pct").read(run) is None
    # the newest trace is another run's
    assert spec.reader("idle_loop_pct").read(Record(
        trace_host=tracing.read(EVENTS))) is None
    assert spec.reader("idle_loop_pct").read(Record()) is None
