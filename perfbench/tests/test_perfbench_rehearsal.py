"""The cell machinery on the CPU at a few hundred rows: configurations,
traffic and metrics found by name, the closed loop of cycles, the
traced stretch, the readers and the result line; the check passes the
program and fails its float32 control and each fault a cell can have.
The measurement path itself refuses to run without a card."""
import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

from mpi_bicgstab_tpu_torch import api
from perfbench import spec
from perfbench.harness import CellRun, Record

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import run as run_py  # noqa: E402

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
# rows at which each generator's cells solve in well under a second
SMALL = {"transport_hard": 343, "transport_like": 512}
DEVICE = {"platform": "gpu", "kind": "rehearsal", "count": 1,
          "memory_peak_bytes": 1}


def _cell_run(name, dtype=None):
    cell = spec.load_cell(name)
    r = CellRun(cell, device="cpu", dtype=dtype,
                n=SMALL[cell.config["generator"]])
    r.setup()
    r.use_seed(2**31 + 11)
    return cell, r


def _finish(cell, r, trace=False):
    r.free_program()
    worst, failed, judged = r.check()
    return run_py.result(cell, r, trace, dict(DEVICE), worst, failed, judged)


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_of_a_cell(name, tmp_path, monkeypatch):
    monkeypatch.setattr("perfbench.harness.TRACE_DIR", tmp_path)
    cell, r = _cell_run(name)
    cell.traffic["trace_iters"] = 10     # a short stretch: the CPU's profile
    r.record.setup_s = 1.0
    r.window(0.01, trace="rehearsal")
    P = int(cell.traffic["rhs_pool"])
    rhs = [s["rhs"] for s in r.record.solves]
    assert len(rhs) % P == 0 and sorted(rhs[:P]) == list(range(P))
    assert r.kept        # the stretch, after the window, keeps its answers
    line = _finish(cell, r, trace=True)
    assert line["correct"] is True, line
    assert line["attempted"] == len(rhs) and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["checks"]["max_true_relres"]) == {"value", "limit"}
    # no card ran: device metrics are left out, the host's are there
    names = {k.split(".")[0] for k in line["metrics"]}
    assert "build_s" in names and "n_iter" in names
    assert "device_idle_pct" not in names
    assert not any(k.endswith("_roofline") for k in line["metrics"])
    assert sorted(tmp_path.iterdir())
    e2e = run_py.metrics_of(cell, r, False)
    assert {m.name for m in cell.end_to_end} - {"peak_mem_gb",
                                                "device_solve_s"} <= set(e2e)
    json.dumps(line)


def test_a_window_under_the_cards_profile(tmp_path, monkeypatch):
    """A cell timed on the card profiles every cycle of its window and
    writes no trace file; with no card the profile holds no
    operation of one, so the card's time is not reported."""
    monkeypatch.setattr("perfbench.harness.TRACE_DIR", tmp_path)
    cell = spec.load_cell("hard-df32")
    assert [m.name for m in cell.end_to_end
            if getattr(m.reader, "WINDOW_TRACE", False)] == ["device_solve_s"]
    assert not any(getattr(m.reader, "WINDOW_TRACE", False)
                   for m in cell.per_layer)
    r = CellRun(cell, device="cpu", n=SMALL[cell.config["generator"]])
    r.card_trace = True
    r.setup()
    r.use_seed(2**31 + 11)
    r.window(0.01)
    assert r.record.solves and r.record.window_traced == 0
    assert not list(tmp_path.iterdir())
    assert "device_solve_s" not in run_py.metrics_of(cell, r, False)
    assert _finish(cell, r)["correct"] is True


def test_the_cards_time_to_a_solution():
    read = spec.reader("device_solve_s").read
    rec = dataclasses.replace(Record(), window_busy_s=3.0,
                              window_traced=4,
                              solves=[{"n_iter": 1, "seconds": 1.0}] * 4)
    assert read(rec) == 0.75
    assert read(dataclasses.replace(rec, window_traced=3)) is None
    assert read(dataclasses.replace(rec, window_busy_s=0.0)) is None
    assert read(dataclasses.replace(rec, solves=[], window_traced=0)) is None
    host = spec.reader("host_solve_s").read
    assert host(dataclasses.replace(rec, window_s=6.0)) == 1.5


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The program's float32 path in place of the cell's precision."""
    cell, r = _cell_run(name, dtype="float32")
    r.window(0.01)
    line = _finish(cell, r)
    assert line["correct"] is False
    v = line["checks"]["max_true_relres"]["value"]
    assert v is None or v > r.limit


def _x0_like(x):
    if hasattr(x, "hi"):
        return type(x)(torch.zeros_like(x.hi), torch.zeros_like(x.lo))
    return torch.zeros_like(x)


def _broken(kind, real):
    """api.solve / api.solve_shifted with a fault planted in the answer."""
    calls = [0]

    def fn(*a, **kw):
        res = real(*a, **kw)
        field = "x_set" if hasattr(res, "x_set") else "x"
        x = getattr(res, field)
        calls[0] += 1
        if kind == "unchanged":            # the state returned as it came
            x = _x0_like(x)
        elif kind == "half_batch":         # half of the batch left out
            if field == "x_set":
                half = x.shape[0] // 2
                x = type(x)(x.hi.clone(), x.lo.clone()) if hasattr(x, "hi") \
                    else x.clone()
                for t in ((x.hi, x.lo) if hasattr(x, "hi") else (x,)):
                    t[half:] = 0
            elif calls[0] % 2 == 0:        # every other right-hand side
                x = _x0_like(x)
        elif kind == "altered":            # one answer changed where made
            x = type(x)(x.hi.clone(), x.lo.clone()) if hasattr(x, "hi") \
                else x.clone()
            t = x.hi if hasattr(x, "hi") else x
            t[..., t.shape[-1] // 2] += 1e-3
        return dataclasses.replace(res, **{field: x})
    return fn


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, kind, monkeypatch):
    """Each fault a one-chip cell can have (no exchange between chips
    exists in it), planted under the harness in the program's answer."""
    cell, r = _cell_run(name)
    entry = "solve_shifted" if r.shifted else "solve"
    monkeypatch.setattr(api, entry, _broken(kind, getattr(api, entry)))
    r.window(0.01)
    line = _finish(cell, r)
    assert line["correct"] is False
    assert line["failed"] >= 1


def test_a_run_that_judged_nothing_is_not_correct():
    cell, r = _cell_run(CELLS[0])
    r.window(0.01)
    r.kept = []
    line = _finish(cell, r)
    assert line["correct"] is False and line["failed"] == 0


def test_the_measurement_path_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine "
                    "without one")
    assert run_py.main(["--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "nothing measured" in out.err
