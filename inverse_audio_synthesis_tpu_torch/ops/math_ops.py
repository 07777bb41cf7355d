"""Elementwise math built from exactly rounded float32 mul/add/floor/bitcast only.

Counterpart of the JAX package's ``ops/math_ops.py``. Oscillator pitch goes
through ``exp2`` and then through ~1e5 rad of accumulated phase over a 4 s
buffer, so a relative frequency error eps becomes an absolute phase error of
~3e5*eps rad. These versions evaluate the same rounding sequence on every
backend: eager torch on the CPU gives JAX's bits, and the CUDA render kernel
(csrc/render_fwd.cu) repeats them with FMA contraction disabled.

Each function takes and returns float32 tensors. Every step is one torch op on
float32, so no op fuses two roundings into one.
"""

from __future__ import annotations

import torch

# degree-6 least-squares fit of 2^f on [-0.5, 0.5] (the JAX package's coefficients)
EXP2_COEFFS = (
    0.00015332508,
    0.0013394702,
    0.009618491,
    0.055503424,
    0.24022648,
    0.6931472,
    1.0,
)

_TWO_OVER_PI = 0.6366197723675814
# Cody-Waite split of pi/2: n*HI and n*MID are exact for integer |n| <= 2^12
PIO2_HI = 1.5703125
PIO2_MID = 4.837512969970703e-04
PIO2_LO = 7.549790126404332e-08

# fdlibm k_sinf/k_cosf minimax coefficients
SIN_COEFFS = (
    2.7183114939898219064e-06,
    -1.98393348360966317347e-04,
    8.3333293858894631756e-03,
    -1.66666666416265235595e-01,
)
COS_COEFFS = (
    2.43904487962774090654e-05,
    -1.38867637746099294692e-03,
    4.16666233237390631894e-02,
    -4.99999997251031003120e-01,
)

_TWO_LOG2E = 2.885390081777927


def exp2_accurate(x: torch.Tensor) -> torch.Tensor:
    """2**x for float32 ``x`` in (-126, 127): x = n + f, |f| <= 0.5, 2^f by Horner,
    2^n by building the exponent field."""
    x = x.float()
    n = torch.floor(x + 0.5)
    f = x - n
    p = torch.full_like(f, EXP2_COEFFS[0])
    for c in EXP2_COEFFS[1:]:
        p = p * f + c
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return p * scale


def _sincos_reduced(x: torch.Tensor):
    """Quadrant reduction and kernel polynomials: (s, c, k) with sin/cos of x the
    quadrant selections of (s, c) by k = n mod 4."""
    x = x.float()
    n = torch.floor(x * _TWO_OVER_PI + 0.5)
    q = x - n * PIO2_HI
    q = q - n * PIO2_MID
    q = q - n * PIO2_LO
    z = q * q
    ps = torch.full_like(z, SIN_COEFFS[0])
    for c in SIN_COEFFS[1:]:
        ps = ps * z + c
    s = q + q * (z * ps)
    pc = torch.full_like(z, COS_COEFFS[0])
    for c in COS_COEFFS[1:]:
        pc = pc * z + c
    c = 1.0 + z * pc
    k = n.to(torch.int32) & 3
    return s, c, k


def _pick(k, a, b, c, d):
    return torch.where(k == 0, a, torch.where(k == 1, b, torch.where(k == 2, c, d)))


def sincos_fast(x: torch.Tensor):
    """(sin x, cos x) for float32 ``|x| <= 4096`` from one shared reduction."""
    s, c, k = _sincos_reduced(x)
    return _pick(k, s, c, -s, -c), _pick(k, c, -s, -c, s)


def sin_fast(x: torch.Tensor) -> torch.Tensor:
    s, c, k = _sincos_reduced(x)
    return _pick(k, s, c, -s, -c)


def cos_fast(x: torch.Tensor) -> torch.Tensor:
    s, c, k = _sincos_reduced(x)
    return _pick(k, c, -s, -c, s)


def tanh_fast(x: torch.Tensor) -> torch.Tensor:
    """tanh(x) = (2^(2x log2 e) - 1) / (2^(2x log2 e) + 1), |x| clipped to 43
    (as jnp.clip: minimum of maximum, half the gradient to each side at a tie)."""
    x = x.float()
    x = torch.minimum(torch.maximum(x, x.new_full((), -43.0)), x.new_full((), 43.0))
    y = exp2_accurate(x * _TWO_LOG2E)
    return (y - 1.0) / (y + 1.0)
