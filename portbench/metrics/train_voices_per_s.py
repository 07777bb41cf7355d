"""Voices trained per second: every step's batch over the window's seconds."""

from portbench.metrics import _read


def read(ctx):
    return _read.rate(ctx, "voices")
