"""Nothing the harness or the reference loads is JAX or the JAX package
(top-level module names compared whole: the port's own name begins with the
JAX package's), the reference imports nothing of the port, and a run without a
card prints no result."""

import ast
import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "inverse_audio_synthesis_tpu")
PORT = "inverse_audio_synthesis_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_port_or_jax():
    files = sorted((ROOT / "portbench" / "reference").glob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in FORBIDDEN + (PORT, "portbench"), (f.name, name)


def test_no_benchmark_file_imports_jax():
    for f in sorted((ROOT / "portbench").rglob("*.py")):
        for name in _imports(f):
            assert name.split(".")[0] not in FORBIDDEN, (f, name)


def test_a_tiny_run_loads_no_jax_module():
    """A whole CPU run of every tiny cell in one fresh process, then its modules."""
    code = f"""
import sys, io, contextlib, importlib.util
sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(ROOT / 'portbench' / 'tests')!r})
from pathlib import Path
import conftest
run = conftest.load_run()
from portbench.core import spec
spec.ROOT = spec.DATA = conftest.HERE / "fixtures"
for cell in ("tiny.pretrain", "tiny.combined"):
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        assert run.run(["--workload", cell, "--seed", "5", "--seconds", "0.5", "--trace", "0"], device="cpu") == 0
import portbench.counts.model_flops, portbench.calibrate
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert PORT in loaded and not loaded & set(FORBIDDEN)


def test_without_a_card_a_run_prints_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          "vicreg-full.pretrain-b16-k4", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
