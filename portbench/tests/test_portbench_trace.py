"""The traced window's arithmetic and the per-layer readers on a summary made
by hand."""

import pytest


def test_busy_is_the_union_of_device_intervals_inside_the_window():
    from portbench.core.trace import busy_and_gaps

    busy, gaps = busy_and_gaps([(0, 4), (2, 6), (8, 9), (12, 20)], lo=1, hi=15)
    assert busy == (6 - 1) + (9 - 8) + (15 - 12)
    assert gaps == [(6, 8), (9, 12)]
    assert busy_and_gaps([], 0, 10) == (0, [(0, 10)])


def test_gaps_are_named_by_the_innermost_host_operation():
    from portbench.core.trace import name_gaps

    host = [(0, 100, "outer"), (10, 20, "aten::conv2d"), (30, 60, "aten::add"), (40, 50, "cudaLaunchKernel")]
    named = name_gaps([(12, 16), (41, 45), (70, 80), (200, 210)], host)
    assert named == {"aten::conv2d": 4, "cudaLaunchKernel": 4, "outer": 10, "no host operation": 10}


def _ctx(**trace):
    summary = {"window_s": 2.0, "busy_s": 1.5, "launch_calls": {"kernel": 300, "graph": 5},
               "kernels": {"void render_kernel<13>(float const*)": (0.004, 2), "render_bwd_kernel<13>": (0.01, 1),
                           "fft_r2c": (0.02, 4), "gemm": (1.0, 10)},
               "gaps": []}
    summary.update(trace)
    config = {"torchsynth": {"buffer_size_seconds": 4.0, "rate": 44100, "control_rate": 441}}
    return {"trace": summary, "profiled": [{"steps": 10}], "config": config,
            "launches": [("render_fwd", 16)] * 2 + [("render_bwd", 16)], "model_flops": 8e13,
            "window": {"seconds": 10.0, "units": [{"steps": 10, "voices": 160, "t": 0.5}] * 20}}


def test_readers():
    from portbench.core import spec
    from portbench.counts import render

    ctx = _ctx()
    read = {m: spec.metric_reader(m).read(ctx) for m in (
        "device_idle_pct.train", "host_launch_calls_per_step.train", "k1_roofline.train", "k2_roofline.train",
        "fft_device_ms_per_step.train", "mfu.train", "train_voices_per_s")}
    assert read["device_idle_pct.train"] == pytest.approx(25.0)
    assert read["host_launch_calls_per_step.train"] == pytest.approx(30.5)
    assert read["k1_roofline.train"] == pytest.approx(100 * 2 * render.least_seconds("render_fwd", 16, 176400, 1764) / 0.004)
    assert read["k2_roofline.train"] == pytest.approx(100 * render.least_seconds("render_bwd", 16, 176400, 1764) / 0.01)
    assert read["fft_device_ms_per_step.train"] == pytest.approx(2.0)
    assert read["mfu.train"] == pytest.approx(100 * 8e13 / 10.0 / 989e12)
    assert read["train_voices_per_s"] == pytest.approx(320.0)
    # nothing to read: no profiled steps
    ctx["profiled"] = []
    assert spec.metric_reader("device_idle_pct.train").read(ctx) is None
    assert spec.metric_reader("host_launch_calls_per_step.train").read(ctx) is None


def test_a_roofline_with_launches_missing_from_the_trace_is_not_read():
    from portbench.core import spec

    ctx = _ctx(kernels={"void render_kernel<13>(float const*)": (0.004, 1)})
    assert spec.metric_reader("k1_roofline.train").read(ctx) is None
