"""BENCHMARK.json keeps to the benchmark's contract, and every name in
it has its file: configuration, traffic, and a metric reader whose unit,
layer and `moves` are the entry's."""
import json
import re
from pathlib import Path

import pytest

from perfbench import spec

ROOT = Path(__file__).resolve().parents[2]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "perfbench/run.py"]
    assert B["paths"] == ["perfbench"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configurations():
    assert 1 <= len(B["configs"]) <= 24
    used = {w["config"] for w in B["workloads"]}
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in body for k in c["reduced"])


def test_cells():
    names = [w["name"] for w in B["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = {(w["config"], w["traffic"]) for w in B["workloads"]}
    assert len(pairs) == len(names)
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= 1
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()


def test_metrics():
    e2e = {m["name"] for m in B["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) == len(B["end_to_end"])
    cells = {w["name"] for w in B["workloads"]}
    for m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert _line(m["layer"]) and set(m["workloads"]) <= cells
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(set(names)) == len(names)
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("m", [m["name"] for m in B["per_layer"]])
def test_each_reader_declares_its_entry(m):
    entry = next(e for e in B["per_layer"] if e["name"] == m)
    r = spec.reader(m)
    assert (r.UNIT, r.LAYER, r.MOVES) == (entry["unit"], entry["layer"],
                                          entry["moves"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in B["workloads"]:
        cell = spec.load_cell(w["name"])
        e2e = {m.name for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.end_to_end:
            assert m.reader.UNIT == m.unit


def test_a_roofline_share_names_a_kernel_group():
    for m in B["per_layer"]:
        if "roofline" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
            assert m["name"].endswith("_roofline")
            group = m["name"][: -len("_roofline")]
            assert (ROOT / "perfbench" / "roofline" / f"{group}.py").is_file()
