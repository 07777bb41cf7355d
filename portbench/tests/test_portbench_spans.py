"""The spans' reduction (``core/spans.py``) on tuples and profiler events made by
hand, and the six span readers on a summary made by hand."""

from types import SimpleNamespace

import pytest
import torch

from portbench.core import spans

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _step(t0):
    """One eager step's spans from t0: 10 s of loop/iteration holding the four
    phases, 2 s each, from t0 + 1."""
    out = [(t0, t0 + 10, "loop/iteration")]
    for i, name in enumerate(("step/synth", "step/forward", "step/backward", "step/optimizer")):
        out.append((t0 + 1 + 2 * i, t0 + 3 + 2 * i, name))
    return out


def test_nest_gives_parents_and_innermost_walks_a_stack():
    found = spans.nest([(0, 10, "a"), (1, 5, "b"), (2, 3, "c"), (6, 9, "d"), (20, 30, "e")])
    assert [(s[2], s[3]) for s in found] == [("a", None), ("b", 0), ("c", 1), ("d", 0), ("e", None)]
    assert spans.innermost(found, [2.5, 4, 5.5, 7, 15, 25, -1]) == [2, 1, 0, 3, None, 4, None]


def test_a_kernel_running_after_its_span_ended_counts_under_it():
    """The forward's kernel is launched at 4 and runs 12-14, in the optimizer's
    time: it is the forward's, by its launching call, and the loop's."""
    found = spans.nest(_step(0))
    host = [(7, 4.0, "cudaLaunchKernel"), (8, 7.5, "cudaLaunchKernel")]
    device = [(12, 14, 7), (14, 15, 8), (15, 16, None)]
    got = spans.reduce(found, device, host, [], 0, 20)
    assert got["device_s"] == {"step/forward": 2, "step/optimizer": 1, "loop/iteration": 3}
    assert got["unplaced_device_s"] == 1
    assert got["launch_calls"] == {"step/forward": 1, "step/optimizer": 1, "loop/iteration": 2}
    assert got["entered"] == {n: 1 for _, _, n in _step(0)}


def test_device_time_is_a_union_clipped_to_the_window():
    found = spans.nest(_step(0))
    host = [(1, 3.5, "cudaLaunchKernel"), (2, 3.6, "cudaLaunchKernel")]
    got = spans.reduce(found, [(2, 6, 1), (5, 8, 2)], host, [], 3, 7)
    assert got["device_s"]["step/forward"] == pytest.approx(4)


def test_idle_splits_into_step_loop_profiler_and_outside():
    found = spans.nest(_step(0))
    gaps = [(2, 2.5, "aten::mul"),           # in step/synth
            (9.2, 9.6, "aten::item"),        # in loop/iteration, after the optimizer
            (4, 5, "Buffer Flush"),          # the profiler's, inside a step span
            (11, 13, "no host operation")]   # outside every iteration
    got = spans.reduce(found, [], [], gaps, 0, 20)
    assert got["idle_s"] == pytest.approx({"step": 0.5, "loop": 0.4, "profiler": 1.0, "outside": 2.0})
    assert sum(got["idle_s"].values()) == pytest.approx(sum(e - s for s, e, _ in gaps))
    assert got["idle_under"] == pytest.approx({"step/synth": 0.5, "loop/iteration": 0.9})


def test_a_gap_deep_under_a_long_span_is_still_the_spans():
    """``trace.name_gaps`` walks back 4,096 host events; the span stack does not."""
    found = spans.nest([(0, 10_000, "loop/iteration"), (1, 9_999, "step/backward")])
    got = spans.reduce(found, [], [], [(9_000.2, 9_000.4, "aten::add")], 0, 10_000)
    assert got["idle_s"]["step"] == pytest.approx(0.2)


def _event(name, start, end, device=CPU, thread=1, id=0, user=False):
    return SimpleNamespace(name=name, device_type=device, thread=thread, id=id, is_user_annotation=user,
                           time_range=SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start))


def test_collect_reads_a_profilers_events():
    """Microseconds in, seconds out. A device annotation named like a span is
    not device work: its time stays idle. A gap is named by the busiest
    thread's innermost operation (here one that began 5,000 events before the
    midpoint); the kernel launched from another thread belongs to the span
    open on the window's thread at its launch."""
    small = [_event("aten::view", 101 + i * 1e-2, 101 + i * 1e-2 + 5e-3, thread=1) for i in range(5000)]
    events = small + [
        _event("portbench/window", 0, 1000, user=True),
        _event("step/backward", 5, 900, user=True),
        _event("aten::mm", 100, 300),
        _event("cudaLaunchKernel", 110, 120, thread=2, id=41),
        _event("step/backward", 5, 900, device=CUDA, user=True),  # the card's copy of the range
        _event("gemm", 400, 600, device=CUDA, id=41),
        _event("Buffer Flush", 700, 800, thread=1),
    ]
    found, device, host, gaps, lo, hi = spans.collect(events)
    assert [s[2] for s in found] == ["step/backward"] and (lo, hi) == (0, 1e-3)
    assert device == [(400e-6, 600e-6, 41)] and host == [(41, 110e-6, "cudaLaunchKernel")]
    assert [g[2] for g in gaps] == ["aten::mm", "Buffer Flush"]
    got = spans.reduce(found, device, host, gaps, lo, hi)
    assert got["device_s"] == {"step/backward": pytest.approx(200e-6)}
    assert got["launch_calls"] == {"step/backward": 1}
    assert got["idle_s"] == pytest.approx({"step": 400e-6, "loop": 0, "profiler": 400e-6, "outside": 0})


READERS = {
    "synth_device_ms_per_step.train": 10.0,
    "forward_device_ms_per_step.train": 80.0,
    "backward_device_ms_per_step.train": 40.0,
    "optimizer_device_ms_per_step.train": 2.0,
    "step_idle_ms_per_step.train": 50.0,
    "loop_idle_ms_per_step.train": 0.5,
}


def _ctx(entered, steps=8):
    found = {"device_s": {"step/synth": 0.08, "step/forward": 0.64, "step/backward": 0.32,
                          "step/optimizer": 0.016, "loop/iteration": 1.06},
             "launch_calls": {}, "idle_under": {}, "entered": entered,
             "idle_s": {"step": 0.4, "loop": 0.004, "profiler": 0.01, "outside": 0.0},
             "unplaced_device_s": 0.0}
    return {"trace": {"window_s": 1.5, "busy_s": 1.06, "spans": found}, "profiled": [{"steps": steps}]}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_readers(metric):
    from portbench.core import spec

    read = spec.metric_reader(metric).read
    eager = {"loop/iteration": 8, "step/synth": 8, "step/forward": 8, "step/backward": 8, "step/optimizer": 8}
    assert read(_ctx(eager)) == pytest.approx(READERS[metric])
    # graph replays: no phase spans, the step's idle is the replay's
    graphs = _ctx({"loop/iteration": 2, "step/graph_replay": 2})
    assert read(graphs) == (READERS[metric] if metric.endswith("idle_ms_per_step.train") else None)
    # no step spans at all (a program without them), or no trace
    assert read(_ctx({})) is None
    assert read({"trace": {"window_s": 1.5, "busy_s": 1.0}, "profiled": [{"steps": 8}]}) is None
