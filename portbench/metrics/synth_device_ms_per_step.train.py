"""Device milliseconds per profiled training step of the synth under
``step/synth``: the parameter draw, the controls and K1 on the true
parameters; None unless every profiled step entered the span once (a graph
replay enters none)."""

from portbench.core import spans


def read(ctx):
    return spans.phase_ms_per_step(ctx, "step/synth")
