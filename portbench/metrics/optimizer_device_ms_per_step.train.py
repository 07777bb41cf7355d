"""Device milliseconds per profiled training step of the optimizer under
``step/optimizer``: the gradients' bf16 cast where it applies and LARS; None
unless every profiled step entered the span once (a graph replay enters none)."""

from portbench.core import spans


def read(ctx):
    return spans.phase_ms_per_step(ctx, "step/optimizer")
