"""The AST tower's attention: the least time of the profiled voices' attention
FLOPs, forward and backward (``counts/attention.py``), at the card's bf16 peak,
over the device time of the fused attention kernels, found by name in the
trace (graph replays hide the program's spans). None where the trace holds
none, or not as many as the profiled steps launch."""

from portbench.counts import attention, peaks
from portbench.metrics import _read


def read(ctx):
    tree = ctx["config"]
    steps, voices = _read.profiled(ctx, "steps"), _read.profiled(ctx, "voices")
    if not steps or not attention.launches_per_step(tree):
        return None
    seconds, count = _read.kernel_seconds(ctx, attention.is_attention_kernel)
    if not seconds or count != attention.launches_per_step(tree) * steps:
        return None
    least = attention.flops_per_voice(tree) * voices / peaks.BF16_FLOP_PER_S
    return 100.0 * least / seconds
