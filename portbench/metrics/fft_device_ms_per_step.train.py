"""Device milliseconds of the FFT kernels (the spectral stack's cuFFT calls) per
profiled training step; None where a step runs no FFT."""

from portbench.metrics import _read


def read(ctx):
    seconds, count = _read.kernel_seconds(ctx, lambda name: "fft" in name.lower())
    steps = _read.profiled(ctx, "steps")
    return 1e3 * seconds / steps if count and steps else None
