"""Idle device milliseconds per profiled training step whose midpoint lies in a
``step/*`` span (an eager step's phases or a graph's replay): the host inside
the step holds the device; None where no such span ran."""

from portbench.core import spans


def read(ctx):
    return spans.idle_ms_per_step(ctx, "step")
