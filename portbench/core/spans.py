"""The program's spans in a traced window: device time, launch calls and idle
time by phase.

The port marks its phases with ``record_function`` ranges that exist only
under a profiler (``utils/profiling.py:span``): ``loop/iteration`` around
each dispatch of the training loop, ``step/synth``, ``step/forward``,
``step/backward`` and ``step/optimizer`` inside an eager step,
``step/graph_replay`` and ``step/graph_capture`` on the graph path.

- A device operation belongs to the spans open on the main thread when the
  host call that launched it was made (the runtime call with the operation's
  correlation id: ``cudaLaunchKernel``, ``cudaGraphLaunch``, ``cudaMemcpyAsync``
  ...), children included, wherever it then ran. A backward kernel is launched
  from autograd's device thread while the main thread waits inside
  ``step/backward``, so time, not the thread, places a call.
- An idle gap of the window (``trace.busy_and_gaps``) is the profiler's where
  the innermost host operation at its midpoint is the profiler's own work,
  else ``step`` where the midpoint lies in a ``step/*`` span, ``loop`` where it
  lies in ``loop/iteration`` outside every ``step/*`` span, else ``outside``.

``collect`` reads the tuples from a stopped profiler's events; ``reduce``
takes plain tuples, so it is tested without a card. Nesting is walked with a
stack over the spans, which one thread opens and closes in order.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from portbench.core import trace

# the profiler's own host work (CUPTI's overhead records, as the trace names
# them), under which an idle gap is its cost
PROFILER_OPS = ("Buffer Flush", "Activity Buffer Request", "Command Buffer Full")
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch")
STEP, LOOP = "step/", "loop/iteration"

Span = Tuple[float, float, str, Optional[int]]  # start, end, name, index of the parent span


def nest(intervals: Iterable[Tuple[float, float, str]]) -> List[Span]:
    """(start, end, name) ranges of one thread -> spans with their parents,
    sorted by start (outer first at equal starts)."""
    out: List[Span] = []
    stack: List[int] = []
    for s, e, name in sorted(intervals, key=lambda r: (r[0], -r[1])):
        while stack and out[stack[-1]][1] <= s:
            stack.pop()
        out.append((s, e, name, stack[-1] if stack else None))
        stack.append(len(out) - 1)
    return out


def innermost(spans: Sequence[Span], times: Sequence[float]) -> List[Optional[int]]:
    """For each time, the index of the innermost span (of ``nest``'s order)
    holding it, or None."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    out: List[Optional[int]] = [None] * len(times)
    stack: List[int] = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            while stack and spans[stack[-1]][1] < spans[j][0]:
                stack.pop()
            stack.append(j)
            j += 1
        while stack and spans[stack[-1]][1] < t:
            stack.pop()
        out[i] = stack[-1] if stack else None
    return out


def _chains(spans: Sequence[Span]) -> List[frozenset]:
    """Each span's name and its ancestors' names."""
    chains: List[frozenset] = []
    for s in spans:  # parents come first in nest's order
        chains.append(frozenset([s[2]]) | (chains[s[3]] if s[3] is not None else frozenset()))
    return chains


def reduce(spans: Sequence[Span], device: Sequence[Tuple[float, float, Optional[int]]],
           host: Sequence[Tuple[int, float, str]], gaps: Sequence[Tuple[float, float, str]],
           lo: float, hi: float) -> Dict:
    """Per span name over the window [lo, hi]: ``device_s``, the union of the
    intervals (clipped to the window) of the device operations launched under
    it; ``launch_calls``, the host's kernel and graph launch calls under it;
    ``idle_under``, the seconds of the gaps not the profiler's whose midpoint
    lies in it; ``entered``, the spans of that name that began in the window.
    ``idle_s``: the gaps' seconds split into step, loop, profiler and outside.
    ``unplaced_device_s``: device time of operations with no launching call.

    spans: ``nest``'s output; device: (start, end, id of the launching host
    call, or None); host: (id, start, name) of the host's runtime calls; gaps:
    (start, end, innermost host operation at the midpoint)."""
    chains = _chains(spans)
    empty: frozenset = frozenset()
    at = innermost(spans, [h[1] for h in host])
    call_chain = {h[0]: (chains[k] if k is not None else empty) for h, k in zip(host, at)}
    launch_calls: Dict[str, int] = defaultdict(int)
    for h, k in zip(host, at):
        if h[2] in LAUNCH_CALLS and lo <= h[1] <= hi and k is not None:
            for name in chains[k]:
                launch_calls[name] += 1
    under: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    unplaced: List[Tuple[float, float]] = []
    for s, e, link in device:
        if link not in call_chain:
            unplaced.append((s, e))
        for name in call_chain.get(link, ()):
            under[name].append((s, e))
    idle = {"step": 0.0, "loop": 0.0, "profiler": 0.0, "outside": 0.0}
    idle_under: Dict[str, float] = defaultdict(float)
    for (s, e, op), k in zip(gaps, innermost(spans, [(g[0] + g[1]) / 2 for g in gaps])):
        chain = chains[k] if k is not None else empty
        kind = ("profiler" if op in PROFILER_OPS else
                "step" if any(n.startswith(STEP) for n in chain) else
                "loop" if LOOP in chain else "outside")
        idle[kind] += e - s
        for name in chain if kind != "profiler" else ():
            idle_under[name] += e - s
    entered: Dict[str, int] = defaultdict(int)
    for s in spans:
        if lo <= s[0] <= hi:
            entered[s[2]] += 1
    return {
        "device_s": {n: trace.busy_and_gaps(v, lo, hi)[0] for n, v in under.items()},
        "launch_calls": dict(launch_calls),
        "idle_under": dict(idle_under),
        "entered": dict(entered),
        "idle_s": idle,
        "unplaced_device_s": trace.busy_and_gaps(unplaced, lo, hi)[0],
    }


def collect(events):
    """``reduce``'s arguments, in seconds, from a stopped profiler's events (as
    ``trace.reduce`` reads them: microseconds on the profiler's clock, the
    window a ``trace.WINDOW`` range). The spans are the user ranges of the
    thread that opened the window; the device operations and the idle gaps
    are ``trace.reduce``'s, and a gap's host operation is the innermost one
    at its midpoint on the thread ``trace.name_gaps`` reads (the busiest)."""
    cpu = torch.autograd.DeviceType.CPU
    window = next(e for e in events if e.device_type == cpu and e.name == trace.WINDOW)
    lo, hi = window.time_range.start, window.time_range.end
    annotations = {e.name for e in events if e.device_type == cpu and getattr(e, "is_user_annotation", False)}
    annotations.add(trace.WINDOW)
    ranges, host, device, threads = [], [], [], defaultdict(list)
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type != cpu:
            if e.name not in annotations and not e.name.startswith("ProfilerStep"):
                device.append((start, end, e.id))
            continue
        if e.name != trace.WINDOW:
            threads[e.thread].append((start, end, e.name))
        if e.name in annotations and e.thread == window.thread and e.name != trace.WINDOW:
            ranges.append((start / 1e6, end / 1e6, e.name))
        elif e.name.startswith("cu"):  # a CUDA API call (cuda*, cu*): its id is the operation's
            host.append((e.id, start / 1e6, e.name))
    _, gaps = trace.busy_and_gaps([(s, e) for s, e, _ in device], lo, hi)
    main = max(threads, key=lambda t: len(threads[t])) if threads else None
    ops = nest(threads.get(main, []))
    named = [(s / 1e6, e / 1e6, ops[k][2] if k is not None else "no host operation")
             for (s, e), k in zip(gaps, innermost(ops, [(s + e) / 2 for s, e in gaps]))]
    device = [(s / 1e6, e / 1e6, link) for s, e, link in device]
    return nest(ranges), device, host, named, lo / 1e6, hi / 1e6


def summary(events) -> Dict:
    """``reduce`` over a stopped profiler's events."""
    return reduce(*collect(events))


# -- what the per-layer readers share (ctx: metrics/_read.py) -------------------------


def _spans_and_steps(ctx):
    from portbench.metrics import _read

    return ((ctx.get("trace") or {}).get("spans"), _read.profiled(ctx, "steps"))


def phase_ms_per_step(ctx, name: str):
    """Device ms under span ``name`` per profiled step; None unless each
    profiled step entered it once."""
    found, steps = _spans_and_steps(ctx)
    if not found or not steps or found["entered"].get(name, 0) != steps:
        return None
    return 1e3 * found["device_s"].get(name, 0.0) / steps


def idle_ms_per_step(ctx, kind: str):
    """Idle ms of ``kind`` (``step`` or ``loop``) per profiled step; None where
    no span of that kind began in the window."""
    found, steps = _spans_and_steps(ctx)
    if not found or not steps:
        return None
    ran = [n for n in found["entered"] if (n.startswith(STEP) if kind == "step" else n == LOOP)]
    return 1e3 * found["idle_s"][kind] / steps if ran else None
