"""Share of the profiled training window with nothing running on the device."""

from portbench.metrics import _read


def read(ctx):
    return _read.idle_pct(ctx, "steps")
