"""Launch counts of the port's hand-written CUDA kernels, and the CUDA graphs that
record them.

Each kernel module counts its launches in its own dict (``counter``), e.g.
``ops/render.py:launch_counts`` and ``ops/lars.py:launch_counts``; ``reset``
zeroes them all. While a CUDA graph is captured (``recording_launches``) the
kernels launched are recorded into the graph and run at each replay, so they are
counted into the dict that ``recording_launches`` yields and not at the call;
``count_replay`` adds them to their modules' counts at each replay.

``CapturedGraph`` is the port's one capture and replay of a CUDA graph, and
``autocast`` the autocast of code that may be captured. What a graph needs of the
code it captures: every tensor it touches is updated in place, never rebound;
host values enter through its input buffer; the generators it draws from are
registered with it; autocast caches no cast under capture (a cached cast would be
made once, at capture); and the code ran once eagerly before, so that lazy
set-up (libraries, cuBLAS and cuDNN handles, cached filters) happens outside the
capture: the callers keep this last rule.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import torch

from inverse_audio_synthesis_tpu_torch.utils.profiling import span

log = logging.getLogger(__name__)

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


def reset() -> None:
    """Zero every kernel module's launch counts."""
    for name, counts in _counts_of.items():
        counts[name] = 0


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


def autocast(device: torch.device, enabled: bool):
    """bf16 autocast on ``device`` when ``enabled``, with no cast cache while the
    current CUDA stream is capturing a graph."""
    capturing = device.type == "cuda" and torch.cuda.is_current_stream_capturing()
    return torch.autocast(device_type=device.type, dtype=torch.bfloat16, enabled=enabled,
                          cache_enabled=not capturing)


class CapturedGraph:
    """``fn(inputs)`` captured into a CUDA graph on the static device buffer
    ``inputs`` (nothing runs at capture; it runs at each replay), with
    ``generators`` registered, inside the ``step/graph_capture`` span, its kernel
    launches recorded (``launches``) and logged as ``captured <what>``.
    ``outputs`` is what ``fn`` returned: the graph's buffers, which each replay
    overwrites."""

    def __init__(self, fn: Callable[[torch.Tensor], Any], inputs: torch.Tensor, what: str,
                 generators: Sequence[torch.Generator] = ()):
        self.inputs = inputs
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        with span("step/graph_capture"), recording_launches() as recorded, torch.cuda.graph(self.graph):
            self.outputs = fn(inputs)
        self.launches = dict(recorded)
        log.info("captured %s (%s kernel launches recorded)", what, self.launches)

    def replay(self, values) -> Any:
        """Copy ``values`` into the inputs (a tensor without blocking, so pin a host
        one; a number by ``fill_``), replay, count the recorded launches, and return
        ``outputs``."""
        if isinstance(values, torch.Tensor):
            self.inputs.copy_(values, non_blocking=True)
        else:
            self.inputs.fill_(values)
        self.graph.replay()
        count_replay(self.launches)
        return self.outputs
