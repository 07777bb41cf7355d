"""Tracing and numerics debugging.

Counterpart of the JAX package's ``utils/profiling.py``:

- ``trace(log_dir)``: a ``torch.profiler`` trace of the work inside the context,
  CPU activity plus the card's kernels on a CUDA run, written on exit as a Chrome
  trace (``trace-<utc>-<pid>.json``, viewable in Perfetto or chrome://tracing)
  into ``log_dir``. The CLIs wrap the whole fit in it when ``profile_dir`` is set.
- ``enable_nan_debugging()``: torch's anomaly mode, the counterpart of
  ``jax_debug_nans``: a backward function that returns NaN raises, naming the
  function, with the traceback of the forward op that made it. ``nan_debugging``
  is the same as a context that restores the previous mode on exit.
- ``span(name)``: a named range of the program's work (the training loop's and
  step's phases, the retrieval sub-chunk's stages) that a running profiler
  records, on its clock, beside the card's kernels: ``record_function(name)``
  while a profiler runs (``trace``, the benchmark's traced window,
  ``tools/profile_torch_port_step.py``), else one shared null context, so a
  span costs one check when nothing is profiled. The names are the README's.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path
from typing import Iterator, Optional

import torch

from inverse_audio_synthesis_tpu_torch.utils.utils import utcstr


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None) -> Iterator[torch.profiler.profile]:
    """Profile the body; on exit write its Chrome trace into ``log_dir``. ``cuda``
    (default: whether a card is present) adds the card's activity."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() if cuda is None else cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    with prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace-{utcstr()}-{os.getpid()}.json"))


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler runs, else a null context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def enable_nan_debugging() -> None:
    """Turn on anomaly mode for the rest of the process (``jax_debug_nans``)."""
    torch.autograd.set_detect_anomaly(True)


@contextlib.contextmanager
def nan_debugging(enabled: bool = True) -> Iterator[None]:
    """Anomaly mode on (or off) inside the context, the previous mode after it."""
    before = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enabled)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(before)
