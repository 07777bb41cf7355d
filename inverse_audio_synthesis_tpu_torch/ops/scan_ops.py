"""Phase accumulation, chunked prefix sums and control-rate upsampling for the
portable render.

Counterpart of the JAX package's ``ops/scan_ops.py``. The portable render
(synth/voice.py:render_voice) uses these for the geometries the render kernel
does not take, such as a non-integer audio/control ratio; the kernel and its
plain version (ops/render.py) integrate phase by 100-sample segments instead.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

TWO_PI = 2.0 * math.pi


def fmod_floor(x: torch.Tensor, y: float) -> torch.Tensor:
    """``jnp.mod`` for floats: the exact ``fmod`` remainder moved into [0, y)
    (floored semantics: mod(-1, 2*pi) is 5.283, not -1)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & (r < 0), r + y, r)


def _pad_to_chunk(x: torch.Tensor, chunk: int) -> torch.Tensor:
    pad = (-x.shape[-1]) % chunk
    return F.pad(x, (0, pad)) if pad else x


def chunked_cumsum(x: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """Cumulative sum over the last axis in chunks of ``chunk``: each chunk's
    prefix sums plus the exclusive cumsum of the chunk totals (the JAX package's
    association; the last chunk is zero-padded, which only receives sums)."""
    *lead, t = x.shape
    if t <= chunk:
        return torch.cumsum(x, dim=-1)
    x = _pad_to_chunk(x, chunk)
    n_chunks = x.shape[-1] // chunk
    within = torch.cumsum(x.reshape(*lead, n_chunks, chunk), dim=-1)
    totals = within[..., -1]
    offsets = torch.cumsum(totals, dim=-1) - totals
    return (within + offsets[..., None]).reshape(*lead, n_chunks * chunk)[..., :t]


def phase_cumsum(dphi: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """Cumulative phase with 2pi-wrapped chunk offsets: equal to cumsum(dphi)
    modulo 2pi, for use inside periodic functions only. The running offsets stay
    below chunk*2pi, where float32 trig is accurate; an unwrapped sum over 176,400
    samples would reach ~1e5 rad."""
    *lead, t = dphi.shape
    if t <= chunk:
        return fmod_floor(torch.cumsum(dphi, dim=-1), TWO_PI)
    x = _pad_to_chunk(dphi, chunk)
    n_chunks = x.shape[-1] // chunk
    within = torch.cumsum(x.reshape(*lead, n_chunks, chunk), dim=-1)
    totals = fmod_floor(within[..., -1], TWO_PI)
    inclusive = (
        phase_cumsum(totals, chunk) if n_chunks > chunk else torch.cumsum(totals, dim=-1)
    )
    offsets = fmod_floor(inclusive - totals, TWO_PI)
    return (within + offsets[..., None]).reshape(*lead, n_chunks * chunk)[..., :t]


def linear_upsample(control: torch.Tensor, n_out: int) -> torch.Tensor:
    """[..., Tc] -> [..., n_out] by linear interpolation with half-pixel centers and
    edge clamping (``jax.image.resize(method='linear')`` when upsampling)."""
    *lead, tc = control.shape
    if n_out % tc != 0:
        flat = control.reshape(-1, 1, tc)
        out = F.interpolate(flat, size=n_out, mode="linear", align_corners=False)
        return out.reshape(*lead, n_out)
    r = n_out // tc
    if r == 1:
        return control
    j = (torch.arange(r, dtype=torch.float32, device=control.device) + 0.5) / r - 0.5
    prev = torch.cat([control[..., :1], control[..., :-1]], dim=-1)
    nxt = torch.cat([control[..., 1:], control[..., -1:]], dim=-1)
    w = torch.abs(j)
    neighbor = torch.where(j < 0, prev[..., :, None], nxt[..., :, None])
    out = control[..., :, None] * (1.0 - w) + neighbor * w
    return out.reshape(*lead, n_out)
