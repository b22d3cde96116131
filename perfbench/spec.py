"""Finding a cell's pieces by name: its entry in BENCHMARK.json, its
configuration (configs/<config>.json), its traffic (traffic/<traffic>.json)
and the metrics it reports (metrics/<metric>.py)."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    reader: object          # module with read(run) -> float | None


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple       # Metric, reported with --trace 0
    per_layer: tuple        # Metric, reported with --trace 1


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def reader(name: str):
    """metrics/<name>.py as a module."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell: str, reported: set) -> bool:
    """A metric with a `workloads` list is reported in those cells; one
    without, in every cell that reports the end-to-end metric it moves
    (an end-to-end metric without the list: in every cell)."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return "moves" not in entry or entry["moves"] in reported


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell `name` of BENCHMARK.json, or of `bench` where given (a
    cell that is not in the file: perfbench/ranks.py's entry, the tests).
    A cell on more than one chip runs the port's distributed solve
    (perfbench/ranks.py), which takes only the traffic entry `solve` and
    no metric that `reads_spans`."""
    bench = bench or load_benchmark()
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"unknown workload {name!r}; BENCHMARK.json has "
                       f"{sorted(by_name)}")
    w = by_name[name]
    config = _json(HERE / "configs" / f"{w['config']}.json")
    traffic = _json(HERE / "traffic" / f"{w['traffic']}.json")
    if int(w["chips"]) > 1 and traffic["entry"] != "solve":
        raise ValueError(f"{name}: a cell on {w['chips']} chips runs "
                         f"solve_distributed, and its traffic "
                         f"{w['traffic']!r} asks for {traffic['entry']!r}; "
                         f"across ranks only 'solve' runs")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    cell = Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=tuple(Metric(m["name"], m["unit"],
                                        reader(m["name"])) for m in e2e),
                per_layer=tuple(Metric(m["name"], m["unit"],
                                       reader(m["name"])) for m in layer))
    blind = [m.name for m in cell.end_to_end + cell.per_layer
             if reads_spans(m.reader)]
    if cell.chips > 1 and blind:
        raise ValueError(f"{name}: a cell on {cell.chips} chips cannot "
                         f"report {blind}: they read the program's spans, "
                         f"and the distributed route's df32 loop opens no "
                         f"`mbt.iter`, its exchanges and waits no span")
    return cell


def reads_spans(mod) -> bool:
    """Does a reader (metrics/<name>.py) read the program's spans through
    perfbench/spans.py? A `.dev` twin that borrows another reader's
    `read` does when that reader does."""
    from perfbench import spans
    return mod.read.__globals__.get("spans") is spans
