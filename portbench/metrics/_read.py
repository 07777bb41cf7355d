"""What the metric readers share. ``ctx`` is the run's record: ``window``
(seconds and unit records of the unprofiled window), ``setup_s``,
``peak_bytes``, ``config``, and in a traced run ``trace`` (the profiled
summary, ``core/trace.py``), ``profiled`` (its unit records), ``launches``
((kernel, batch) of each render launch the profiled work makes) and
``model_flops`` (of the unprofiled window's work, ``counts/model_flops.py``)."""

from __future__ import annotations

from portbench.counts import peaks, render


def total(records, key: str) -> float:
    return float(sum(r.get(key, 0) for r in records))


def profiled(ctx, key: str) -> float:
    return total(ctx.get("profiled") or [], key)


def rate(ctx, key: str):
    """Per second of the window, over all of its units; None when no unit did it."""
    w = ctx["window"]
    n = total(w["units"], key)
    return n / w["seconds"] if n and w["seconds"] > 0 else None


def idle_pct(ctx, key: str):
    t = ctx.get("trace")
    if not t or not profiled(ctx, key) or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def launch_calls_per(ctx, key: str):
    t = ctx.get("trace")
    n = profiled(ctx, key)
    if not t or not n or t["busy_s"] <= 0:
        return None
    return sum(t["launch_calls"].values()) / n


def kernel_seconds(ctx, match) -> tuple:
    """(device seconds, launches) of the kernels whose name ``match`` accepts."""
    kernels = (ctx.get("trace") or {}).get("kernels", {})
    hits = [v for name, v in kernels.items() if match(name)]
    return sum(v[0] for v in hits), sum(v[1] for v in hits)


def is_k1(name: str) -> bool:
    return "render_kernel" in name


def is_k2(name: str) -> bool:
    return "render_bwd_kernel" in name


def roofline_pct(ctx, kernel: str, match, key: str):
    """The least time of the profiled launches of ``kernel`` (counts/render.py)
    over their device time; None when the trace holds none of them, or not as
    many as the profiled units launch."""
    if not profiled(ctx, key):
        return None
    seconds, count = kernel_seconds(ctx, match)
    launches = [b for k, b in ctx.get("launches", []) if k == kernel]
    if not seconds or count != len(launches):
        return None
    ta, tc = render.geometry(ctx["config"])
    least = sum(render.least_seconds(kernel, b, ta, tc) for b in launches)
    return 100.0 * least / seconds


def mfu_pct(ctx, key: str):
    """The unprofiled window's model FLOPs over its seconds, against the bf16 peak."""
    w = ctx["window"]
    if not ctx.get("trace") or not total(w["units"], key) or not ctx.get("model_flops"):
        return None
    return 100.0 * ctx["model_flops"] / w["seconds"] / peaks.BF16_FLOP_PER_S
