"""Tracing, numerics debugging and a step timer.

Counterpart of the JAX package's ``utils/profiling.py``:

- ``trace(log_dir)``: a ``torch.profiler`` trace of the work inside the context,
  CPU activity plus the card's kernels on a CUDA run, written on exit as a Chrome
  trace (``trace-<utc>-<pid>.json``, viewable in Perfetto or chrome://tracing)
  into ``log_dir``. The CLIs wrap the whole fit in it when ``profile_dir`` is set.
- ``enable_nan_debugging()``: torch's anomaly mode, the counterpart of
  ``jax_debug_nans``: a backward function that returns NaN raises, naming the
  function, with the traceback of the forward op that made it. ``nan_debugging``
  is the same as a context that restores the previous mode on exit.
- ``StepTimer``: steady-state steps/s and voices/s after a warm-up.
"""

from __future__ import annotations

import contextlib
import os
import time
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


class StepTimer:
    def __init__(self, warmup_steps: int = 2, batch_size: int = 1):
        self.warmup_steps = warmup_steps
        self.batch_size = batch_size
        self._count = 0
        self._t0: Optional[float] = None

    def tick(self) -> None:
        self._count += 1
        if self._count == self.warmup_steps:
            self._t0 = time.time()

    @property
    def steps_per_sec(self) -> float:
        measured = self._count - self.warmup_steps
        if self._t0 is None or measured <= 0:
            return 0.0
        return measured / max(time.time() - self._t0, 1e-9)

    @property
    def voices_per_sec(self) -> float:
        return self.steps_per_sec * self.batch_size
