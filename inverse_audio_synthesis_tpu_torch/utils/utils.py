"""Small run utilities: a UTC timestamp and the repository's git commit.

Counterpart of the JAX package's ``utils/utils.py``. Its ``enable_compile_cache``
is not ported: it turns on XLA's persistent compilation cache, and the port
compiles no XLA programs. Its only compiled code, the render kernels, is already
built once per source into ``build/kernels`` (``ops/render.py``).
"""

from __future__ import annotations

import datetime
import functools
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent


def utcstr() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%d-%H-%M-%S")


@functools.lru_cache(maxsize=1)
def git_sha() -> str:
    """``git rev-parse HEAD`` of the checkout this package lies in; '' when it is
    not a git checkout or git is unavailable. Run at the first call, not at
    import."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True, text=True,
            timeout=10, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""
