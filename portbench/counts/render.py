"""Operations and bytes of the render kernels from their shapes, frozen.

K1 (the forward render) reads the noise, the routed controls [B, 5, Tc] and the
per-voice scalars [B, 16] once and writes the audio [B, Ta] once. Its float32
operations per audio sample, each value counted once: the interpolation offset
4, five upsampled controls 16, per oscillator 32 (pitch 6, exp2 18, increment
2, phase 6) x 2, two sin/cos reductions 27 x 2, tanh 27, the square/saw morph 6,
the VCAs and the mix 11: 182.

K2 (its backward) reads the noise and the audio cotangent, the controls, the
scalars and the segment means and phase offsets the forward saved ([B, 2,
Tcp], Tcp = Tc rounded up to 32) once, and writes the control and scalar
cotangents once. Per audio sample: the forward recomputed up to the
oscillators and VCAs 171; the VCA, oscillator and mixer cotangents 46; their
per-segment sums 25; per oscillator in the backward walk 16 x 2: 274.

The least time of a launch is the larger of its bytes over the memory rate and
its float32 operations over the float32 rate.
"""

from __future__ import annotations

from . import peaks

K1_FLOPS_PER_SAMPLE = 182
K2_FLOPS_PER_SAMPLE = 171 + 46 + 25 + 2 * 16
SEG_TILE = 32


def k1(batch: int, ta: int, tc: int):
    """(float32 operations, bytes) of one forward render."""
    return K1_FLOPS_PER_SAMPLE * batch * ta, 4 * (batch * ta + batch * 5 * tc + batch * 16 + batch * ta)


def k2(batch: int, ta: int, tc: int):
    """(float32 operations, bytes) of one backward render."""
    tcp = -(-tc // SEG_TILE) * SEG_TILE
    return K2_FLOPS_PER_SAMPLE * batch * ta, 4 * (2 * batch * ta + 2 * batch * 5 * tc + 2 * batch * 16 + 2 * batch * 2 * tcp)


KERNELS = {"render_fwd": k1, "render_bwd": k2}


def least_seconds(kernel: str, batch: int, ta: int, tc: int) -> float:
    flops, nbytes = KERNELS[kernel](batch, ta, tc)
    return max(flops / peaks.F32_FLOP_PER_S, nbytes / peaks.HBM_BYTES_PER_S)


def geometry(config):
    """(Ta, Tc) of the configuration's voices."""
    t = config["torchsynth"]
    return (int(round(t["buffer_size_seconds"] * t["rate"])),
            int(round(t["buffer_size_seconds"] * t.get("control_rate", 441))))
