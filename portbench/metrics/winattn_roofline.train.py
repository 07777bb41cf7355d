"""The HTS-AT tower's window attention: the least time of the profiled voices'
attention, forward and backward (``counts/window_attention.py``), the larger
of its FLOPs at the card's bf16 peak and its least bytes at the HBM's peak,
over the device time of the memory-efficient attention kernels, found by
name in the trace (graph replays hide the program's spans). None where the
trace holds none, or not as many as the profiled steps launch."""

from portbench.counts import peaks
from portbench.counts import window_attention as wa
from portbench.metrics import _read


def read(ctx):
    tree = ctx["config"]
    steps, voices = _read.profiled(ctx, "steps"), _read.profiled(ctx, "voices")
    if not steps or not wa.launches_per_step(tree):
        return None
    seconds, count = _read.kernel_seconds(ctx, wa.is_attention_kernel)
    if not seconds or count != wa.launches_per_step(tree) * steps:
        return None
    flops = wa.flops_per_voice(tree) * voices
    moved = wa.bytes_per_voice(tree) * voices + wa.table_bytes_per_step(tree) * steps
    least = max(flops / peaks.BF16_FLOP_PER_S, moved / peaks.HBM_BYTES_PER_S)
    return 100.0 * least / seconds
