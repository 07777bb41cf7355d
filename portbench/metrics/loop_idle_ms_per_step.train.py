"""Idle device milliseconds per profiled training step whose midpoint lies in
``loop/iteration`` outside every ``step/*`` span: the training loop's own work
between dispatches (log fetch, batch numbers, the signal check); None where no
iteration ran."""

from portbench.core import spans


def read(ctx):
    return spans.idle_ms_per_step(ctx, "loop")
