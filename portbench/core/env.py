"""The process's environment, set before torch is imported: every build and
kernel cache at a fixed path inside the checkout (``build/portbench-cache``),
no JAX or flax loaded by a library on the program's behalf, four compute
threads."""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "cuda"}
FORBIDDEN = ("jax", "jaxlib", "flax", "inverse_audio_synthesis_tpu")


def setup() -> None:
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "portbench-cache" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole
    (the port's own name begins with the JAX package's)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))
