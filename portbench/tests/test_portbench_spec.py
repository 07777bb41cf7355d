"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_found(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(config["name"]) and config["file"].startswith("portbench/")
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["source"] == config["source"] and data["reduced"] == config["reduced"] == []
    assert "config" in data
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found(cell):
    from portbench.core import spec

    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200
    c = spec.load_cell(cell["name"])
    assert (ROOT / "portbench" / "jobs" / f"{c.traffic['job']}.py").exists()
    assert c.limits["limits"], "a cell's limits decide correct"
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_found(metric):
    from portbench.core import spec

    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert callable(spec.metric_reader(metric["name"]).read)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_a_reported_metric(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    moved = e2e[metric["moves"]]
    assert set(metric["workloads"]) <= set(moved.get("workloads", metric["workloads"]))
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}["setup_s"] == 0.25


def test_the_fixture_cells_judge_by_the_real_limits():
    """The CPU tests' tiny cells hold the limits of the cells that run the same
    job and traffic kind, so the fault and control tests judge by them."""
    fixtures = ROOT / "portbench" / "tests" / "fixtures"
    pairs = {"tiny.pretrain": "vicreg-full.pretrain-b16-k4", "tiny.combined": "a2p-small.combined-b1024",
             "tiny.embedding": "a2p-small.embedding-b1024"}
    for tiny, real in pairs.items():
        mine = json.loads((fixtures / "cells" / f"{tiny}.json").read_text())
        theirs = json.loads((ROOT / "portbench" / "cells" / f"{real}.json").read_text())
        assert mine == theirs, tiny
