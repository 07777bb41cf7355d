"""Launch counts of the port's hand-written CUDA kernels, and the launches a CUDA
graph records.

Each kernel module counts its launches in its own dict (``counter``), e.g.
``ops/render.py:launch_counts`` and ``ops/lars.py:launch_counts``. While a CUDA
graph is captured (``recording_launches``) the kernels launched are recorded into
the graph and run at each replay, so they are counted into the dict that
``recording_launches`` yields and not at the call; ``count_replay`` adds them to
their modules' counts at each replay.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

# kernel name -> the dict that counts its launches
_counts_of: Dict[str, Dict[str, int]] = {}
_recording: Optional[Dict[str, int]] = None


def counter(*names: str) -> Dict[str, int]:
    """A dict of launch counts, one per kernel name (names are unique across modules)."""
    counts = dict.fromkeys(names, 0)
    for name in names:
        if name in _counts_of:
            raise ValueError(f"kernel {name!r} is counted twice")
        _counts_of[name] = counts
    return counts


def count(name: str) -> None:
    """One launch of ``name``: counted now, or recorded while a graph is captured."""
    (_counts_of[name] if _recording is None else _recording)[name] += 1


@contextlib.contextmanager
def recording_launches() -> Iterator[Dict[str, int]]:
    """Wrap the capture of a CUDA graph: yields the launches it records, by kernel."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a CUDA graph capture is already recording launches")
    _recording = dict.fromkeys(_counts_of, 0)
    try:
        yield _recording
    finally:
        _recording = None


def count_replay(recorded: Dict[str, int]) -> None:
    """One replay of a graph whose capture recorded ``recorded`` launches."""
    for name, n in recorded.items():
        _counts_of[name][name] += n
