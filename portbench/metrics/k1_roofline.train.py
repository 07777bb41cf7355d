"""K1's least time (counts/render.py) over its device time, in the profiled
training steps."""

from portbench.metrics import _read


def read(ctx):
    return _read.roofline_pct(ctx, "render_fwd", _read.is_k1, "steps")
