"""DSP modules of the Voice synthesizer, as plain functions on tensors.

Counterpart of the JAX package's ``synth/modules.py``: each function maps batched
natural-unit parameters ([B] tensors) to control-rate [B, Tc] or audio-rate
[B, Ta] signals. Max and clip against constants are ``maximum``/``clip`` below:
``torch.maximum``/``torch.minimum`` against 0-dim tensors, which pass half the
gradient to each side at a tie, as ``jnp.maximum`` and ``jnp.clip`` do
(``torch.clamp`` passes all of it). The forward values are the same.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from inverse_audio_synthesis_tpu_torch.ops.math_ops import (
    cos_fast,
    exp2_accurate,
    sincos_fast,
    tanh_fast,
)
from inverse_audio_synthesis_tpu_torch.ops.scan_ops import TWO_PI, fmod_floor, phase_cumsum
from inverse_audio_synthesis_tpu_torch.synth import prng

_EPS = 1e-9


def midi_to_hz(midi: torch.Tensor) -> torch.Tensor:
    return 440.0 * exp2_accurate((midi - 69.0) / 12.0)


def maximum(x: torch.Tensor, lo: float) -> torch.Tensor:
    """jnp.maximum(x, lo): at x == lo the gradient is split 0.5/0.5."""
    return torch.maximum(x, torch.full((), lo, dtype=x.dtype, device=x.device))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi), gradients as JAX's."""
    return torch.minimum(maximum(x, lo), torch.full((), hi, dtype=x.dtype, device=x.device))


def _relu(x: torch.Tensor) -> torch.Tensor:
    return maximum(x, 0.0)


# ---------------------------------------------------------------------------
# ADSR envelope (control rate)
# ---------------------------------------------------------------------------


def _ramp(n_samples: int, rate: float, duration, alpha, start=None, inverse=False):
    """Clamped linear ramp 0->1 over ``duration`` from ``start``, raised to ``alpha``;
    with ``inverse`` the ramp is 1 - y."""
    t = torch.arange(n_samples, dtype=torch.float32, device=duration.device)[None, :]
    dur = (duration * rate)[:, None]
    st = 0.0 if start is None else (start * rate)[:, None]
    y = clip((t - st) / maximum(dur, _EPS), 0.0, 1.0)
    if inverse:
        y = 1.0 - y
    positive = y > 0.0
    safe = torch.where(positive, y, torch.ones_like(y))
    return torch.where(positive, torch.pow(safe, alpha[:, None]), torch.zeros_like(y))


def adsr_envelope(
    params: Dict[str, torch.Tensor], note_on_duration, n_samples: int, control_rate: float
) -> torch.Tensor:
    """Attack/decay/release composed multiplicatively (each phase in [0,1])."""
    attack = torch.minimum(params["attack"], note_on_duration)
    decay = torch.minimum(
        maximum(note_on_duration - params["attack"], 0.0), params["decay"]
    )
    alpha = params["alpha"]
    attack_sig = _ramp(n_samples, control_rate, attack, alpha)
    sustain = params["sustain"][:, None]
    decay_sig = (1.0 - sustain) * _ramp(
        n_samples, control_rate, decay, alpha, start=attack, inverse=True
    ) + sustain
    release_sig = _ramp(
        n_samples, control_rate, params["release"], alpha, start=note_on_duration,
        inverse=True,
    )
    return attack_sig * decay_sig * release_sig


# ---------------------------------------------------------------------------
# LFO (control rate)
# ---------------------------------------------------------------------------

LFO_SHAPES = ("sin", "tri", "saw", "rsaw", "sqr")
_LFO_SELECTION_EXPONENT = math.e


def lfo(params: Dict[str, torch.Tensor], rate_mod: torch.Tensor, control_rate: float):
    """Rate-modulated LFO: five unit-range shapes blended by normalized,
    exponent-sharpened selection weights. Output in [0, 1]."""
    freq = params["frequency"][:, None]
    freq = maximum(freq + params["mod_depth"][:, None] * rate_mod, 0.0)
    argument = torch.cumsum(2.0 * math.pi * freq / control_rate, dim=1)
    argument = argument + params["initial_phase"][:, None]

    cos = (torch.cos(argument + math.pi) + 1.0) / 2.0
    square = (torch.sign(torch.cos(argument + math.pi)) + 1.0) / 2.0
    saw = fmod_floor(argument, TWO_PI) / TWO_PI
    rsaw = 1.0 - saw
    tri = 2.0 * saw
    tri = torch.where(tri > 1.0, 2.0 - tri, tri)
    shapes = torch.stack([cos, tri, saw, rsaw, square], dim=1)  # [B, 5, Tc]

    weights = torch.stack([params[s] for s in LFO_SHAPES], dim=1)  # [B, 5]
    weights = torch.pow(weights, _LFO_SELECTION_EXPONENT)
    weights = weights / maximum(weights.sum(dim=1, keepdim=True), _EPS)
    return torch.einsum("bs,bst->bt", weights, shapes)


# ---------------------------------------------------------------------------
# VCOs (audio rate)
# ---------------------------------------------------------------------------


def _vco_argument(midi_f0, tuning, mod_depth, initial_phase, pitch_mod, sample_rate):
    """Pitch modulation in MIDI space, clamped to [0, 127], converted to Hz and
    integrated into 2pi-wrapped phase. The increment is freq times one constant
    (2pi/sr rounded once to float32), as in the render kernel."""
    control_as_midi = clip(
        (midi_f0 + tuning)[:, None] + mod_depth[:, None] * pitch_mod, 0.0, 127.0
    )
    freq = midi_to_hz(control_as_midi)
    argument = phase_cumsum((2.0 * math.pi / sample_rate) * freq)
    return argument + initial_phase[:, None], control_as_midi


def sine_vco(params, midi_f0, pitch_mod, sample_rate) -> torch.Tensor:
    arg, _ = _vco_argument(
        midi_f0, params["tuning"], params["mod_depth"], params["initial_phase"],
        pitch_mod, sample_rate,
    )
    return cos_fast(arg)


def squaresaw_partials(midi_f0, tuning, mod_depth) -> torch.Tensor:
    """Band-limit partials constant from the maximum possible pitch."""
    max_pitch = midi_f0 + tuning + maximum(mod_depth, 0.0)
    max_f0 = midi_to_hz(max_pitch)
    denom = max_f0 * torch.log10(maximum(max_f0, 1.0 + 1e-6))
    return 12000.0 / maximum(denom, _EPS)


def square_saw_vco(params, midi_f0, pitch_mod, sample_rate) -> torch.Tensor:
    """Tanh-saturated sine blended toward saw by ``shape``."""
    arg, _ = _vco_argument(
        midi_f0, params["tuning"], params["mod_depth"], params["initial_phase"],
        pitch_mod, sample_rate,
    )
    partials = squaresaw_partials(midi_f0, params["tuning"], params["mod_depth"])
    shape = params["shape"][:, None]
    sin_a, cos_a = sincos_fast(arg)
    square = tanh_fast(math.pi * partials[:, None] * sin_a / 2.0)
    return (1.0 - shape / 2.0) * square * (1.0 + shape * cos_a)


# ---------------------------------------------------------------------------
# Noise / VCA / mixers / upsampling
# ---------------------------------------------------------------------------


def noise(
    key: torch.Tensor, batch_size: int, n_samples: int, device=None, row_offset: int = 0
) -> torch.Tensor:
    """Fixed white noise in [-1, 1): row i is ``uniform(fold_in(key, row_offset + i))``,
    bit-identical to the JAX package's ``modules.noise``, so a row does not depend
    on the batch size, and ``row_offset`` gives rows ``row_offset..row_offset +
    batch_size`` of the longer buffer. Rows are drawn a few at a time to bound the
    int64 scratch."""
    device = key.device if device is None else device
    rows = row_offset + torch.arange(batch_size, dtype=torch.int64, device=key.device)
    keys = prng.fold_in(key, rows).to(device)
    out = torch.empty((batch_size, n_samples), dtype=torch.float32, device=device)
    step = max(1, (1 << 22) // max(n_samples, 1))
    for i in range(0, batch_size, step):
        out[i : i + step] = prng.uniform(keys[i : i + step], (n_samples,), -1.0, 1.0)
    return out


def vca(audio: torch.Tensor, control: torch.Tensor) -> torch.Tensor:
    """Voltage-controlled amplifier; amplitude control is non-negative."""
    return audio * _relu(control)


def modulation_mixer(weights: torch.Tensor, signals: torch.Tensor) -> torch.Tensor:
    """weights [B, n_in, n_out] . signals [B, n_in, Tc] -> [B, n_out, Tc]."""
    return torch.einsum("bio,bit->bot", weights, signals)


def audio_mixer(levels: torch.Tensor, signals: torch.Tensor) -> torch.Tensor:
    """levels [B, n_in] . signals [B, n_in, Ta] -> [B, Ta]."""
    return torch.einsum("bi,bit->bt", levels, signals)
