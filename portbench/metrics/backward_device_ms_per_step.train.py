"""Device milliseconds per profiled training step of the backward under
``step/backward``: ``torch.autograd.grad`` and the gradient reduction (K2 in
``combined``); None unless every profiled step entered the span once (a graph
replay enters none)."""

from portbench.core import spans


def read(ctx):
    return spans.phase_ms_per_step(ctx, "step/backward")
