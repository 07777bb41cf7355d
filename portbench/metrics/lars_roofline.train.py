"""The LARS step's least time, its least bytes (``counts/lars.py``) for each
profiled step at the card's memory rate, over the device time of the kernels
whose names hold ``lars_``, found by name in the trace (graph replays hide the
program's spans). None where the trace holds none of them, or not 3 a profiled
step (a program without the kernels reads None)."""

from portbench.counts import lars, peaks
from portbench.metrics import _read


def read(ctx):
    steps = _read.profiled(ctx, "steps")
    if not steps:
        return None
    seconds, count = _read.kernel_seconds(ctx, lars.is_lars_kernel)
    if not seconds or count != lars.LAUNCHES_PER_STEP * steps:
        return None
    least = lars.least_bytes(ctx["config"]) * steps / peaks.HBM_BYTES_PER_S
    return 100.0 * least / seconds
