"""Fixtures of the benchmark's CPU tests: the tiny cells of ``fixtures/`` (a
60 x 80 pseudo-image, 0.33 s voices, batch 8, float32) in place of
BENCHMARK.json's, and the harness's entry point."""

import importlib.util
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def load_run():
    spec = importlib.util.spec_from_file_location("portbench_run", ROOT / "portbench" / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def tiny(monkeypatch):
    """Point the harness at the tiny fixture cells."""
    from portbench.core import spec

    monkeypatch.setattr(spec, "ROOT", HERE / "fixtures")
    monkeypatch.setattr(spec, "DATA", HERE / "fixtures")
    return spec


@pytest.fixture
def run_cell(tiny, capsys):
    """run_cell(cell, seed, trace=0) -> the result line of a CPU run, with the
    checks printed to standard error."""
    run = load_run()

    def go(cell: str, seed: int = 3000000001, trace: int = 0, seconds: float = 1.0):
        rc = run.run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                     device="cpu")
        out, err = capsys.readouterr()
        assert rc == 0, err[-2000:]
        return json.loads(out.strip().splitlines()[-1]), err

    return go
