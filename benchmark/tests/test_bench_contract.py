"""BENCHMARK.json keeps to the contract's shape, names and units; every
per-layer metric moves an end-to-end metric that each of its cells
reports; every name the harness looks up has its file."""

import json
import re
from pathlib import Path

import pytest

from benchmark import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield group, entry["name"]
    for w in BENCH["workloads"]:
        yield "config", w["config"]
        yield "traffic", w["traffic"]
    for c in BENCH["configs"]:
        for key in c["reduced"]:
            yield "reduced", key


def test_top_level_keys():
    assert set(BENCH) == KEYS
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmark"]
    assert len(BENCH["command"]) <= 32
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("group,name", list(names()))
def test_names_use_allowed_characters(group, name):
    assert NAME.match(name), (group, name)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert TEXT.match(metric["layer"])
        if "roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


def test_unique_names():
    for group in ("configs", "workloads"):
        seen = [e["name"] for e in BENCH[group]]
        assert len(seen) == len(set(seen))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_the_contract_asks(cell):
    c = spec.cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    assert c.chips == 1
    for m in c.per_layer:
        assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_by_every_cell_of_the_metric(metric):
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    for cell in metric.get("workloads", CELLS):
        e2e = {m["name"] for m in spec.cell(cell).end_to_end}
        assert metric["moves"] in e2e, (metric["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_every_named_file_exists(cell):
    c = spec.cell(cell)
    assert (ROOT / "benchmark" / "drivers"
            / f"{c.traffic['driver']}.py").exists()
    assert c.limits, f"{cell} has no limits for correct"
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(entry):
    assert (ROOT / entry["file"]).is_file()
    assert entry["file"].startswith("benchmark/")
    assert TEXT.match(entry["source"]) and TEXT.match(entry["why"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    own = json.loads((ROOT / entry["file"]).read_text())
    assert own["reduced"] == entry["reduced"]


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_why(entry):
    assert TEXT.match(entry["why"])
    assert entry["chips"] in (1, 4)
