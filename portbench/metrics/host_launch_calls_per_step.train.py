"""The host's kernel and graph launch calls per profiled training step."""

from portbench.metrics import _read


def read(ctx):
    return _read.launch_calls_per(ctx, "steps")
