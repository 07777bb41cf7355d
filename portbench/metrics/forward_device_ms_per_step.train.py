"""Device milliseconds per profiled training step of the forward under
``step/forward``: towers, head and losses (in ``combined``, the mel term with
its second K1 and the STFT stack); None unless every profiled step entered the
span once (a graph replay enters none)."""

from portbench.core import spans


def read(ctx):
    return spans.phase_ms_per_step(ctx, "step/forward")
