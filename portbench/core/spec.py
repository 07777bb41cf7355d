"""What a cell is, read from BENCHMARK.json and the files that it names.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's ``file`` holds the configuration tree as it is run; the
traffic mix is ``portbench/traffic/<traffic>.json`` (its ``job`` names the
driver ``portbench/jobs/<job>.py`` and the rest are that driver's parameters);
the cell's correctness limits are ``portbench/cells/<cell>.json``. Metrics are
read by ``portbench/metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
# where BENCHMARK.json (ROOT) and the traffic and cell files (DATA) are read;
# the CPU tests point both at a fixture
ROOT = BENCH_DIR.parent
DATA = BENCH_DIR


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_benchmark() -> Dict[str, Any]:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    bench = load_benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (there are {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())["config"]
    traffic = json.loads((DATA / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((DATA / "cells" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if m["moves"] in names and _applies(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, layer)


def load_module(path: Path, name: str):
    """Import a file by path (names may hold dots and hyphens)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def job_module(job: str):
    return load_module(BENCH_DIR / "jobs" / f"{job}.py", f"portbench_job_{job}")


def metric_reader(metric: str):
    return load_module(BENCH_DIR / "metrics" / f"{metric}.py", f"portbench_metric_{metric.replace('.', '_')}")
