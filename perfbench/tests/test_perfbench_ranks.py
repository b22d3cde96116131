"""A cell across ranks (perfbench/ranks.py) on the CPU: gloo ranks at
1000 rows of transport-hard, 256 a rank on four, each more than the
band's widest offset (200). Synthetic cells on four and on one rank, of
the classic df32 and float64 traffic, built in memory and never written
into BENCHMARK.json: the four-rank rehearsal reads correct with a
one-chip line's keys, every rank solves one order, one rank gives the
one-device answers bit for bit with the same iterations, each fault
planted under the ranks reads incorrect, a cell that asks several chips
for another entry than `solve`, or for a metric that reads the
program's spans, is refused at load, and a `chips: 4` entry added as
data files alone runs through run.py's dispatch."""
import json
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import harness, ranks, spec
from perfbench.harness import CellRun
from perfbench.reference.generators import GENERATORS
from perfbench.reference.operator import DiaOperator

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import run as run_py  # noqa: E402

N = 1000
SEED = 2**31 + 23
FAULTS = str(Path(__file__).with_name("rank_faults.py"))
# each traffic's one-chip cell, whose metrics a synthetic cell reports
LIKE = {"classic-df32": "hard-df32", "classic-f64": "hard-f64"}
DEVICE = {"platform": "gpu", "kind": "rehearsal", "memory_peak_bytes": 1}


def _config(**over) -> dict:
    """transport-hard at N rows, stating the shapes of N rows."""
    c = json.loads((HERE / "configs" / "transport-hard.json").read_text())
    ref = DiaOperator.from_generator(GENERATORS[c["generator"]], n=N,
                                     seed=c["matrix_seed"])
    c.update(n=N, rows=ref.n, diagonals=ref.n_diags,
             band_entries=ref.band_entries, **over)
    return c


def _traffic(name: str) -> dict:
    t = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    t["trace_iters"] = 10       # a short stretch: the CPU's profile
    return t


def _cell(name, count=4):
    """The synthetic cell of `name`'s traffic on count ranks."""
    return spec.load_cell(*ranks.synthetic(LIKE[name], count))


def _line(name, got, trace=False, count=4):
    return run_py.result(_cell(name, count), got, trace,
                         dict(DEVICE, count=count), *got.checked)


@pytest.fixture(autouse=True)
def _gloo_ranks(monkeypatch, tmp_path):
    monkeypatch.setattr(ranks, "DEVICE", "cpu")
    monkeypatch.setattr(harness, "TRACE_DIR", tmp_path)


@pytest.mark.parametrize("name", sorted(LIKE))
def test_a_four_rank_rehearsal_reads_correct(name, tmp_path):
    got = ranks.run_ranks(_config(), _traffic(name), 4, SEED, 0.01,
                          time.perf_counter(), trace="ranks")
    line = _line(name, got, trace=True)
    assert line["correct"] is True, line
    rhs = [s["rhs"] for s in got.record.solves]
    P = int(_traffic(name)["rhs_pool"])
    assert line["attempted"] == len(rhs) and len(rhs) % P == 0
    assert got.orders == [rhs] * 4            # one order on every rank
    assert sorted(rhs[:P]) == list(range(P))
    assert got.record.setup_s > 0 and got.record.stretch_iters == 10
    # the roofline readers set rank 0's kernels against rank 0's rows
    assert got.record.shapes["n"] == 256
    assert 0 < got.record.shapes["band_entries"] < _config()["band_entries"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ranks.0.json", "ranks.1.json"]       # rank 0's, alone
    # the keys of a one-chip cell's line at the same size
    one = CellRun(spec.load_cell(LIKE[name]), device="cpu", n=N)
    one.setup()
    one.use_seed(SEED)
    one.record.setup_s = 1.0
    one.window(0.01, trace="one")
    one.free_program()
    mine = run_py.result(spec.load_cell(LIKE[name]), one, True,
                         dict(DEVICE, count=1), *one.check())
    assert list(line) == list(mine)
    # the metrics are the one-chip cell's but the readers of the
    # program's spans (on the CPU the card's readers find nothing)
    assert set(line["metrics"]) <= {m.name for m in _cell(name).per_layer}
    assert set(line["metrics"]) == {
        m for m in mine["metrics"]
        if not spec.reads_spans(spec.reader(m))}
    assert set(line["device"]) == set(mine["device"])
    json.dumps(line)


@pytest.mark.parametrize("name", sorted(LIKE))
def test_one_rank_gives_the_one_device_answers(name):
    cfg, traffic = _config(), _traffic(name)
    got = ranks.run_ranks(cfg, traffic, 1, SEED, 0.01, time.perf_counter(),
                          answers=True)
    assert _line(name, got, count=1)["correct"] is True
    assert sorted(got.answers) == list(range(int(traffic["rhs_pool"])))
    cell = spec.Cell(name, 1, cfg, traffic, (), ())
    lines = ranks.same_as_one_device(cell, SEED, got)
    assert len(lines) == len(got.answers)
    for x in lines:
        assert x["bit_equal"] and x["n_iter_ranks"] == x["n_iter_one_device"]


@pytest.mark.parametrize("kind", ["halo", "local_reduction", "rank0_rows"])
@pytest.mark.parametrize("name", sorted(LIKE))
def test_a_fault_under_the_ranks_is_not_correct(name, kind):
    got = ranks.run_ranks(_config(), _traffic(name), 4, SEED, 0.01,
                          time.perf_counter(),
                          task=(FAULTS, "faulty_task", kind))
    line = _line(name, got)
    assert line["correct"] is False
    assert line["failed"] >= 1


def test_a_cell_on_several_chips_takes_only_solve():
    name, bench = ranks.synthetic("shifted512-df32", 4)
    with pytest.raises(ValueError, match="only 'solve'"):
        spec.load_cell(name, bench)
    name, bench = ranks.synthetic("hard-df32", 4)
    cell = spec.load_cell(name, bench)
    assert cell.chips == 4 and [m.name for m in cell.end_to_end] == [
        m.name for m in spec.load_cell("hard-df32").end_to_end]


def test_a_cell_on_several_chips_reports_no_reader_of_spans():
    """The distributed route opens no `mbt.iter` and no span of its
    exchange: a reader of the program's spans would read nothing, or a
    false 0, across ranks."""
    bench = spec.load_benchmark()
    entry = dict(next(w for w in bench["workloads"]
                      if w["name"] == "hard-df32"), name="df32-4", chips=4)
    bench["workloads"].append(entry)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "hard-df32" in m.get("workloads", ()):
            m["workloads"].append("df32-4")
    with pytest.raises(ValueError, match="read the program's spans") as e:
        spec.load_cell("df32-4", bench)
    for blind in ("idle_loop_pct.dev", "host_syncs_per_iter.dev",
                  "idle_launch_pct.dev"):
        assert blind in str(e.value)
    assert spec.reads_spans(spec.reader("idle_loop_pct"))
    assert not spec.reads_spans(spec.reader("device_solve_s"))
    entry["chips"] = 1           # one chip: the one-device route's spans
    assert len(spec.load_cell("df32-4", bench).per_layer) == len(
        spec.load_cell("hard-df32").per_layer)
    name, bench = ranks.synthetic("hard-df32", 4)
    names = {m.name for m in spec.load_cell(name, bench).per_layer}
    assert names and not names & {"idle_loop_pct.dev",
                                  "host_syncs_per_iter.dev",
                                  "idle_launch_pct.dev"}


def test_a_four_chip_cell_added_as_data_runs_through_run_py(
        tmp_path, monkeypatch, capsys):
    """The tree a later PR would bring: a configuration file, the
    traffic it names, and BENCHMARK.json's entries, nothing else."""
    tree = tmp_path / "checkout"
    pb = tree / "perfbench"
    (pb / "configs").mkdir(parents=True)
    (pb / "traffic").mkdir()
    (pb / "metrics").symlink_to(HERE / "metrics")
    cfg = _config(name="transport-hard-4rank")
    (pb / "configs" / "transport-hard-4rank.json").write_text(
        json.dumps(cfg))
    (pb / "traffic" / "classic-f64.json").write_text(
        json.dumps(_traffic("classic-f64")))
    bench = spec.load_benchmark()
    bench["configs"].append({"name": "transport-hard-4rank",
                             "source": cfg["source"],
                             "file": "perfbench/configs/"
                                     "transport-hard-4rank.json",
                             "reduced": [], "why": "main.c on 4 ranks"})
    bench["workloads"].append({"name": "hard-f64-4rank",
                               "config": "transport-hard-4rank",
                               "traffic": "classic-f64", "chips": 4,
                               "why": "the halo exchange and reductions"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "hard-f64" in m.get("workloads", ()) \
                and not spec.reads_spans(spec.reader(m["name"])):
            m["workloads"].append("hard-f64-4rank")
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "HERE", pb)
    monkeypatch.setattr(spec, "ROOT", tree)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "gloo")
    assert run_py.main(["--workload", "hard-f64-4rank", "--seed", str(SEED),
                        "--seconds", "0.01"]) == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["count"] == 4
    assert set(line["metrics"]) == {"solve_s", "setup_s"}
    assert list(line)[-1] == "checks"
    assert out.err.strip().splitlines()[-1].startswith(
        "check max_true_relres")
