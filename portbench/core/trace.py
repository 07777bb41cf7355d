"""The traced part of a ``--trace 1`` run: a profiler window over whole steps
in the middle of the run's work (``Split``), reduced to what the per-layer
metrics read (``reduce``).

- busy: the union of the intervals in which an operation (kernel, copy or
  memset) ran on the device, inside the window (the host interval of the
  profiled units, from the ``portbench/window`` range to the synchronise after
  them); idle = window - busy;
- idle gaps: each stretch of the window with nothing on the device, named by
  the innermost host operation running on the main thread at its midpoint;
- the host's launch calls (kernels, graphs);
- device seconds and counts by kernel name.
"""

from __future__ import annotations

import bisect
import time
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Tuple

import torch

HOST_LAUNCH_CALLS = {
    "kernel": ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx"),
    "graph": ("cudaGraphLaunch", "cuGraphLaunch"),
}
WINDOW = "portbench/window"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_and_gaps(device: List[Tuple[float, float]], lo: float, hi: float):
    """(busy length, [(gap start, gap end)]) of device intervals clipped to [lo, hi]."""
    merged = _union([(max(s, lo), min(e, hi)) for s, e in device if e > lo and s < hi])
    busy = sum(e - s for s, e in merged)
    gaps, t = [], lo
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return busy, gaps


def name_gaps(gaps: List[Tuple[float, float]], host: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Gap length summed by the innermost host operation active at each gap's
    midpoint (host: nested (start, end, name) of one thread)."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    out: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "no host operation"
        # walk back to the latest-starting operation that still covers mid
        for j in range(i, max(i - 4096, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        out[name] += e - s
    return out


class Split:
    """A traced run's window: one continuous piece of work (for training, one
    ``Trainer.fit``), of which the first ``before_s`` seconds run unprofiled
    and the next ``profile_s`` under ``torch.profiler``. ``unit(record)`` is
    called after each unit of work (a dispatch of steps) has been enqueued. At
    the first unit boundary past ``before_s`` the device is synchronised and
    the profiler started; at the first past ``profile_s`` more it is
    synchronised and stopped, and ``unit`` answers True: stop the work. So the
    profiled units continue the same work, and no restart falls inside them.

    After the work: ``before`` (unit records) and ``before_seconds`` (their
    host time, synchronised) of the unprofiled part, ``profiled`` (unit
    records) and ``summary`` (``reduce``) of the profiled one."""

    def __init__(self, before_s: float, profile_s: float, sync: Callable[[], None]):
        self.before_s, self.profile_s, self.sync = before_s, profile_s, sync
        self.before: List[Dict] = []
        self.profiled: List[Dict] = []
        self.before_seconds = 0.0
        self.summary = None
        self._prof = self._range = None
        self._t0 = self._tp = 0.0

    def start(self) -> None:
        self.sync()
        self._t0 = time.perf_counter()

    def unit(self, record: Dict) -> bool:
        now = time.perf_counter()
        if self.summary is not None:
            return True
        if self._prof is None:
            self.before.append(record)
            if now - self._t0 >= self.before_s:
                self.sync()
                self.before_seconds = time.perf_counter() - self._t0
                self._start_profiler()
            return False
        self.profiled.append(record)
        if now - self._tp >= self.profile_s:
            self.stop()
            return True
        return False

    def stop(self) -> None:
        """Stop the profiler where the work ended before ``profile_s`` did."""
        if self._prof is None:
            if self.summary is None and not self.before_seconds:
                self.sync()
                self.before_seconds = time.perf_counter() - self._t0
            return
        self.sync()
        self._range.__exit__(None, None, None)
        self._prof.stop()
        self.summary = reduce(self._prof)
        self._prof = self._range = None

    def _start_profiler(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self._prof = profile(activities=activities)
        self._prof.start()
        self._range = record_function(WINDOW)
        self._range.__enter__()
        self._tp = time.perf_counter()


def reduce(prof) -> Dict:
    """A stopped profiler's events -> the summary the per-layer metrics read."""
    events = prof.events()
    cpu_dev = torch.autograd.DeviceType.CPU
    annotations = {e.name for e in events if e.device_type == cpu_dev and getattr(e, "is_user_annotation", False)}
    annotations.add(WINDOW)
    window = [e for e in events if e.device_type == cpu_dev and e.name == WINDOW]
    lo, hi = window[0].time_range.start, window[0].time_range.end
    device, kernels = [], defaultdict(lambda: [0.0, 0])
    calls: Counter = Counter()
    threads: Counter = Counter()
    host = defaultdict(list)
    for e in events:
        if e.device_type == cpu_dev:
            for kind, names in HOST_LAUNCH_CALLS.items():
                if e.name in names and lo <= e.time_range.start <= hi:
                    calls[kind] += 1
            if e.name != WINDOW:
                threads[e.thread] += 1
                host[e.thread].append((e.time_range.start, e.time_range.end, e.name))
        elif e.name not in annotations and not e.name.startswith("ProfilerStep"):
            device.append((e.time_range.start, e.time_range.end))
            k = kernels[e.name]
            k[0] += e.time_range.elapsed_us() / 1e6
            k[1] += 1
    busy_us, gaps = busy_and_gaps(device, lo, hi)
    main = threads.most_common(1)[0][0] if threads else None
    gap_names = name_gaps(gaps, host.get(main, []))
    summary = {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy_us / 1e6,
        "launch_calls": dict(calls),
        "kernels": {k: tuple(v) for k, v in kernels.items()},
        "gaps": sorted(((n, s / 1e6) for n, s in gap_names.items()), key=lambda kv: -kv[1]),
    }
    return summary


def breakdown(summary: Dict) -> Dict[str, List]:
    ops = sorted(((n, v[0]) for n, v in summary["kernels"].items()), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in summary["gaps"][:10]]}
