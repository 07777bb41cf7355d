"""How the port builds its hand-written CUDA kernels: each ``csrc/<name>.cu`` with
nvcc for sm_90a into a shared library under ``build/kernels``, loaded with ctypes
by its kernel module (``ops/render.py``, ``ops/lars.py``).

A library's file name carries a hash of its source, the headers it includes and
the flags, so an edit rebuilds it and nothing else.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# each source, and the headers of csrc/ it includes
SOURCES = {
    "render_fwd": (CSRC / "render_fwd.cu", (CSRC / "render_common.cuh",)),
    "render_bwd": (CSRC / "render_bwd.cu", (CSRC / "render_common.cuh",)),
    "lars": (CSRC / "lars.cu", ()),
}
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "--fmad=false", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _library_path(name: str) -> Path:
    """build/kernels/<name>-<hash>.so, the hash over the source, its headers and
    the flags."""
    source, headers = SOURCES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (source, *headers):
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc(nvcc: str, name: str, out: Path) -> None:
    """Build ``csrc/<name>.cu`` into ``out`` (written under a temporary name, then
    renamed), keeping nvcc's output beside it as ``<out>.log``."""
    source = SOURCES[name][0]
    tmp = out.with_name(f"{out.name}.tmp-{os.getpid()}")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc {source.name} failed ({proc.returncode}):\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)


def build_libraries(names=tuple(SOURCES)) -> Dict[str, Path]:
    """Compile each named ``csrc/<name>.cu`` with nvcc into a shared library under
    ``build/kernels``, one nvcc process per source, all started together, and
    return their paths. A library already built from the same sources is reused.
    nvcc's output (ptxas register and shared-memory report) is kept beside each
    as ``<name>.log``."""
    out = {name: _library_path(name) for name in names}
    todo = [name for name in names if not out[name].exists()]
    if not todo:
        return out
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the kernels are built on a machine with the CUDA toolkit")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(todo)) as pool:
        for job in [pool.submit(_nvcc, nvcc, name, out[name]) for name in todo]:
            job.result()
    return out
