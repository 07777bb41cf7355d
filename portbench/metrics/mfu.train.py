"""The training step's model FLOPs (counts/model_flops.py) over the unprofiled
window's seconds, against the card's bf16 peak."""

from portbench.metrics import _read


def read(ctx):
    return _read.mfu_pct(ctx, "steps")
