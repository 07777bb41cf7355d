"""The training loop: ``Trainer`` and ``PreemptionGuard``.

Counterpart of the JAX package's ``train/loop.py``: one pass over the
batch-number stream with ``limit_train_batches``, ``limit_val_batches``,
``val_check_interval`` and metric logging every ``log_every`` steps. Non-finite
updates are rejected on the device at every step (train/optim.py); the counter
and the metrics are fetched, and raised on, only at log cadence, so the loop
does not wait for the device between log steps. With a ``CheckpointManager``,
``fit`` saves on its cadence (asynchronously), on preemption and at the end
(``save_last``), and resumes from ``start_step``, as the JAX ``Trainer`` does.

With ``steps_per_dispatch`` k > 1 the loop hands the task up to k batch numbers
at once (``task.train_step_multi``, which returns the metrics stacked [k]).
Each dispatch is clamped so that no log, validation or checkpoint boundary falls
inside it, and the first is one step, so the cadence, the checkpoints and the
logged steps are those of k = 1; decisions read the dispatch's last step. A
signal is polled between dispatches, so a stop comes within k steps. With
``detect_anomaly`` false, non-finite metrics and rejected updates are logged and
not raised.

Under a distributed mesh every rank runs the loop (the steps are collectives);
the metrics are the global batch's, equal on every rank, ``voices_per_sec``
counts the global batch, and the CLIs give rank 0 alone a logger. A signal that
reaches any rank stops every rank at the same step: the ranks agree on it
before each dispatch.

Under a profiler each dispatch is a ``loop/iteration`` span, holding the
task's ``step/*`` spans and, where they run, ``loop/log``, ``loop/validate``
and ``loop/checkpoint`` (``utils/profiling.py:span``; nothing is recorded
without a profiler).
"""

from __future__ import annotations

import math
import signal
import threading
import time
from typing import Any, Dict, Optional

import torch

from inverse_audio_synthesis_tpu_torch.parallel.collectives import agree_max
from inverse_audio_synthesis_tpu_torch.parallel.mesh import Mesh
from inverse_audio_synthesis_tpu_torch.train.checkpoint import CheckpointManager
from inverse_audio_synthesis_tpu_torch.train.runsetup import BatchNumberSplit
from inverse_audio_synthesis_tpu_torch.utils.profiling import span


class PreemptionGuard:
    """Turn SIGTERM/SIGINT into a cooperative stop flag while training. Installs
    handlers only from the main thread; elsewhere it stays inert."""

    def __init__(self):
        self.requested: Optional[int] = None
        self._prev: Dict[int, Any] = {}

    def _handler(self, signum, frame):
        self.requested = signum

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.signal(sig, self._handler)
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
        return False


def _to_float(v) -> float:
    return float(v.item()) if isinstance(v, torch.Tensor) else float(v)


class Trainer:
    def __init__(
        self,
        task,
        split: BatchNumberSplit,
        logger=None,
        checkpoint: Optional[CheckpointManager] = None,
        limit_train_batches: Optional[int] = None,
        limit_val_batches: Optional[int] = None,
        val_check_interval: Optional[int] = None,
        log_every: int = 50,
        detect_anomaly: bool = True,
        steps_per_dispatch: int = 1,
    ):
        self.task = task
        self.split = split
        self.logger = logger
        self.checkpoint = checkpoint
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.val_check_interval = val_check_interval
        self.log_every = log_every
        self.detect_anomaly = detect_anomaly
        self.steps_per_dispatch = max(1, int(steps_per_dispatch or 1))
        # set by fit(): the signal number that stopped training early, else None
        self.interrupted: Optional[int] = None

    def _log(self, metrics: Dict[str, Any], step: int):
        if self.logger is not None:
            self.logger.log(metrics, step=step)

    def validate(self, state, max_batches: Optional[int] = None) -> Dict[str, float]:
        n = min(self.split.sizes.val, max_batches or self.limit_val_batches or self.split.sizes.val)
        if n == 0:
            return {}
        acc: Optional[Dict[str, torch.Tensor]] = None
        for i in range(n):
            m = self.task.val_step(state, self.split.val_batch_num(i))
            acc = m if acc is None else {k: acc[k] + m[k] for k in m}
        return {k: _to_float(v) / n for k, v in acc.items()}

    def fit(self, state, start_step: int = 0):
        n_train = self.split.sizes.train
        if self.limit_train_batches:
            n_train = min(n_train, self.limit_train_batches)
        self.interrupted = None
        # abort on rejections from THIS run only
        self._notfinite_base = _to_float(state.optimizer.total_notfinite)
        with PreemptionGuard() as guard:
            state = self._fit_loop(state, start_step, n_train, guard)
        if self.interrupted == signal.SIGINT:
            raise KeyboardInterrupt
        return state

    def _dispatch_len(self, i: int, n_train: int, start_step: int) -> int:
        """Steps in the next dispatch: at most steps_per_dispatch, clamped so that no
        log, validation or checkpoint boundary falls strictly inside it."""
        stops = [n_train, i + self.steps_per_dispatch]
        if i == start_step:
            stops.append(i + 1)  # the first step always logs
        for m in (
            self.log_every,
            self.val_check_interval,
            self.checkpoint.every_n_steps if self.checkpoint is not None else None,
        ):
            if m:
                stops.append((i // m + 1) * m)  # the next multiple of m after i
        return max(1, min(stops) - i)

    def _fit_loop(self, state, start_step: int, n_train: int, guard):
        window_start = time.time()
        mesh = getattr(self.task, "mesh", None) or Mesh()
        multi = self.steps_per_dispatch > 1 and hasattr(self.task, "train_step_multi")
        i = start_step
        while i < n_train:
            with span("loop/iteration"):
                requested = agree_max(guard.requested, mesh)
                if requested is not None:
                    # finish the dispatch, then stop with a resumable checkpoint
                    self.interrupted = guard.requested = int(requested)
                    if self.checkpoint is not None:
                        with span("loop/checkpoint"):
                            self.checkpoint.save(state, i)
                    self._log({"preempted_by_signal": float(guard.requested)}, step=i)
                    return state
                k = self._dispatch_len(i, n_train, start_step) if multi else 1
                if k > 1:
                    nums = [self.split.train_batch_num(j) for j in range(i, i + k)]
                    state, stacked = self.task.train_step_multi(state, nums)
                    metrics = {key: v[-1] for key, v in stacked.items()}  # the dispatch's last step
                else:
                    state, metrics = self.task.train_step(state, self.split.train_batch_num(i))
                i += k  # steps done; the boundary step's index is i - 1
                first = i - k == start_step
                if i % self.log_every == 0 or first:
                    with span("loop/log"):
                        metrics = {key: _to_float(v) for key, v in metrics.items()}
                        metrics["notfinite_steps"] = (
                            _to_float(state.optimizer.total_notfinite) - self._notfinite_base
                        )
                        now = time.time()
                        steps = k if first else self.log_every
                        metrics["steps_per_sec"] = steps / max(now - window_start, 1e-9)
                        # the synth config's batch is the global batch
                        metrics["voices_per_sec"] = metrics["steps_per_sec"] * self.task.synth.batch_size
                        window_start = now
                        bad = {key: v for key, v in metrics.items() if not math.isfinite(v)}
                        if metrics["notfinite_steps"]:
                            bad["notfinite_steps"] = metrics["notfinite_steps"]
                        if bad and self.detect_anomaly:
                            raise FloatingPointError(
                                f"non-finite metrics by step {i - 1}: {bad} (non-finite "
                                f"updates were rejected on the device, not applied)"
                            )
                        self._log(metrics, step=i - 1)
                if self.val_check_interval and i % self.val_check_interval == 0:
                    with span("loop/validate"):
                        self._log(self.validate(state), step=i - 1)
                if self.checkpoint is not None:
                    with span("loop/checkpoint"):
                        self.checkpoint.maybe_save(state, i)
        if self.checkpoint is not None:
            with span("loop/checkpoint"):
                self.checkpoint.save(state, n_train)  # save_last
        return state
