"""The Voice synthesizer: 78 normalized parameters -> batched audio.

Counterpart of the JAX package's ``synth/voice.py``. The graph (torchsynth-1.0
Voice patch): keyboard, two ADSRs, two rate- and amplitude-enveloped LFOs, a
4 x 5 modulation matrix routing them to {vco_1_pitch, vco_1_amp, vco_2_pitch,
vco_2_amp, noise_amp}, a sine VCO, a square/saw VCO, noise, VCAs and a
3-channel mixer.

The control-rate half (``compute_controls``) is plain torch. The audio-rate half
runs either through ``render_voice`` (plain torch, any geometry) or through the
fused render (ops/render.py: a CUDA kernel for CUDA tensors, its plain version for
CPU tensors) where ``fused_render_available`` says the geometry fits.
``render_voice_auto`` picks between them. Both are differentiable in params01:
the fused render's gradient runs the hand-written backward kernel
(``bwd="pallas"``, the config value ``torchsynth.render_bwd`` keeps the JAX
package's name) or autograd of ``render_voice`` (``bwd="jnp"``).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from inverse_audio_synthesis_tpu_torch.ops.render import (
    fused_render_supported,
    render_audio_fused,
)
from inverse_audio_synthesis_tpu_torch.ops.scan_ops import linear_upsample
from inverse_audio_synthesis_tpu_torch.synth import modules, prng
from inverse_audio_synthesis_tpu_torch.synth.config import SynthConfig
from inverse_audio_synthesis_tpu_torch.synth.parameter import ParamSpec, from_0to1

_PI = math.pi


def _adsr_specs(module: str) -> Tuple[ParamSpec, ...]:
    return (
        ParamSpec(module, "attack", 0.0, 2.0, curve=0.5),
        ParamSpec(module, "decay", 0.0, 2.0, curve=0.5),
        ParamSpec(module, "sustain", 0.0, 1.0),
        ParamSpec(module, "release", 0.0, 5.0, curve=0.5),
        ParamSpec(module, "alpha", 0.1, 6.0),
    )


def _lfo_specs(module: str) -> Tuple[ParamSpec, ...]:
    return (
        ParamSpec(module, "frequency", 0.0, 20.0, curve=0.25),
        ParamSpec(module, "mod_depth", -10.0, 20.0, curve=0.5, symmetric=True),
        ParamSpec(module, "initial_phase", -_PI, _PI),
        ParamSpec(module, "sin", 0.0, 1.0),
        ParamSpec(module, "tri", 0.0, 1.0),
        ParamSpec(module, "saw", 0.0, 1.0),
        ParamSpec(module, "rsaw", 0.0, 1.0),
        ParamSpec(module, "sqr", 0.0, 1.0),
    )


MOD_MATRIX_INPUTS = ("adsr_1", "adsr_2", "lfo_1", "lfo_2")
MOD_MATRIX_OUTPUTS = ("vco_1_pitch", "vco_1_amp", "vco_2_pitch", "vco_2_amp", "noise_amp")


def _build_voice_specs() -> Tuple[ParamSpec, ...]:
    specs = [
        ParamSpec("keyboard", "midi_f0", 0.0, 127.0),
        ParamSpec("keyboard", "duration", 0.01, 4.0, curve=0.5),
    ]
    specs += list(_adsr_specs("adsr_1"))
    specs += list(_adsr_specs("adsr_2"))
    specs += list(_lfo_specs("lfo_1"))
    specs += list(_lfo_specs("lfo_2"))
    specs += list(_adsr_specs("lfo_1_amp_adsr"))
    specs += list(_adsr_specs("lfo_2_amp_adsr"))
    specs += list(_adsr_specs("lfo_1_rate_adsr"))
    specs += list(_adsr_specs("lfo_2_rate_adsr"))
    for inp in MOD_MATRIX_INPUTS:
        for out in MOD_MATRIX_OUTPUTS:
            specs.append(ParamSpec("mod_matrix", f"{inp}->{out}", 0.0, 1.0, curve=0.5))
    specs += [
        ParamSpec("vco_1", "tuning", -24.0, 24.0),
        ParamSpec("vco_1", "mod_depth", -96.0, 96.0, curve=0.2, symmetric=True),
        ParamSpec("vco_1", "initial_phase", -_PI, _PI),
        ParamSpec("vco_2", "tuning", -24.0, 24.0),
        ParamSpec("vco_2", "mod_depth", -96.0, 96.0, curve=0.2, symmetric=True),
        ParamSpec("vco_2", "initial_phase", -_PI, _PI),
        ParamSpec("vco_2", "shape", 0.0, 1.0),
        ParamSpec("mixer", "vco_1", 0.0, 1.0),
        ParamSpec("mixer", "vco_2", 0.0, 1.0),
        # noise level uses a strong curve so random patches are rarely noise-dominated
        ParamSpec("mixer", "noise", 0.0, 1.0, curve=0.025),
    ]
    return tuple(specs)


VOICE_PARAM_SPECS: Tuple[ParamSpec, ...] = _build_voice_specs()
assert len(VOICE_PARAM_SPECS) == 78


def _natural(params01: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
    """[B, 78] normalized -> {module: {name: [B] natural units}}."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for i, spec in enumerate(VOICE_PARAM_SPECS):
        out.setdefault(spec.module, {})[spec.name] = from_0to1(spec, params01[:, i])
    return out


def compute_controls(params01: torch.Tensor, config: SynthConfig):
    """Control-rate half of the Voice graph.

    Returns (natural_params, routed [B, 5, Tc], midi_f0 [B])."""
    if params01.ndim != 2 or params01.shape[1] != len(VOICE_PARAM_SPECS):
        raise ValueError(f"params01 must be [B, 78], got {tuple(params01.shape)}")
    cr = float(config.control_rate)
    tc = config.control_buffer_size
    p = _natural(params01.float())
    midi_f0 = p["keyboard"]["midi_f0"]
    note_on = p["keyboard"]["duration"]

    def env(module: str) -> torch.Tensor:
        return modules.adsr_envelope(p[module], note_on, tc, cr)

    lfo_1 = modules.lfo(p["lfo_1"], env("lfo_1_rate_adsr"), cr) * modules.maximum(
        env("lfo_1_amp_adsr"), 0.0
    )
    lfo_2 = modules.lfo(p["lfo_2"], env("lfo_2_rate_adsr"), cr) * modules.maximum(
        env("lfo_2_amp_adsr"), 0.0
    )
    mods = torch.stack([env("adsr_1"), env("adsr_2"), lfo_1, lfo_2], dim=1)  # [B,4,Tc]
    w = torch.stack(
        [
            torch.stack([p["mod_matrix"][f"{i}->{o}"] for o in MOD_MATRIX_OUTPUTS], 1)
            for i in MOD_MATRIX_INPUTS
        ],
        dim=1,
    )  # [B, 4, 5]
    routed = modules.modulation_mixer(w, mods)  # [B, 5, Tc]
    return p, routed, midi_f0


def make_noise(
    config: SynthConfig, device=None, batch_size: Optional[int] = None, row_offset: int = 0
):
    """The fixed-seed noise buffer [B, Ta], made once per run by its callers
    (rows ``row_offset..row_offset + B`` of the position-keyed stream)."""
    b = config.batch_size if batch_size is None else batch_size
    return modules.noise(
        prng.prng_key(config.noise_seed), b, config.buffer_size, device=device,
        row_offset=row_offset,
    )


def render_voice(
    params01: torch.Tensor, config: SynthConfig, noise: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """[B, 78] normalized params -> [B, buffer_size] audio, in plain torch."""
    sr = float(config.sample_rate)
    ta = config.buffer_size
    b = params01.shape[0]
    p, routed, midi_f0 = compute_controls(params01, config)
    up = [linear_upsample(routed[:, i], ta) for i in range(5)]
    vco_1_pitch, vco_1_amp, vco_2_pitch, vco_2_amp, noise_amp = up
    vco_1 = modules.vca(modules.sine_vco(p["vco_1"], midi_f0, vco_1_pitch, sr), vco_1_amp)
    vco_2 = modules.vca(
        modules.square_saw_vco(p["vco_2"], midi_f0, vco_2_pitch, sr), vco_2_amp
    )
    if noise is None:
        noise = make_noise(config, params01.device, b)
    noise_sig = modules.vca(noise[:b], noise_amp)
    levels = torch.stack(
        [p["mixer"]["vco_1"], p["mixer"]["vco_2"], p["mixer"]["noise"]], dim=1
    )
    return modules.audio_mixer(levels, torch.stack([vco_1, vco_2, noise_sig], dim=1))


def fused_scalars(p, midi_f0: torch.Tensor) -> torch.Tensor:
    """Pack the per-voice scalars the fused render consumes ([B, 16], 11 used)."""
    base1 = midi_f0 + p["vco_1"]["tuning"]
    base2 = midi_f0 + p["vco_2"]["tuning"]
    partials = modules.squaresaw_partials(
        midi_f0, p["vco_2"]["tuning"], p["vco_2"]["mod_depth"]
    )
    cols = [
        base1,
        p["vco_1"]["mod_depth"],
        p["vco_1"]["initial_phase"],
        base2,
        p["vco_2"]["mod_depth"],
        p["vco_2"]["initial_phase"],
        p["vco_2"]["shape"],
        partials,
        p["mixer"]["vco_1"],
        p["mixer"]["vco_2"],
        p["mixer"]["noise"],
    ]
    out = torch.stack(cols, dim=1)
    return F.pad(out, (0, 16 - out.shape[1]))


def fused_render_available(config: SynthConfig) -> bool:
    return fused_render_supported(
        config.batch_size, config.buffer_size, config.control_buffer_size
    )


RENDER_BWD = ("pallas", "jnp")


class _PortableRenderGrad(torch.autograd.Function):
    """The fused render forward, with the gradient of ``render_voice`` (the JAX
    package's ``bwd="jnp"``: its backward re-renders the portable path)."""

    @staticmethod
    def forward(ctx, params01, noise, config):
        ctx.save_for_backward(params01, noise)
        ctx.config = config
        return _render_fused(params01, config, noise)

    @staticmethod
    def backward(ctx, g):
        params01, noise = ctx.saved_tensors
        with torch.enable_grad():
            p = params01.detach().requires_grad_(True)
            (gp,) = torch.autograd.grad(render_voice(p, ctx.config, noise), p, g)
        return gp, None, None


def _render_fused(params01, config: SynthConfig, noise) -> torch.Tensor:
    p, routed, midi_f0 = compute_controls(params01, config)
    scalars = fused_scalars(p, midi_f0)
    return render_audio_fused(
        routed.contiguous(), scalars.contiguous(), noise, float(config.sample_rate)
    )


def render_voice_fused(
    params01: torch.Tensor,
    config: SynthConfig,
    noise: Optional[torch.Tensor] = None,
    bwd: str = "pallas",
) -> torch.Tensor:
    """Audio through the fused render: the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors. Differentiable in params01: ``bwd="pallas"`` runs the
    render's backward kernel (its plain version on the CPU) and autograd through
    the control-rate half; ``bwd="jnp"`` takes the gradient of ``render_voice``.
    ``noise`` rows beyond the batch are ignored, since rows are position-keyed."""
    if bwd not in RENDER_BWD:
        raise ValueError(f"render_bwd must be one of {RENDER_BWD}, got {bwd!r}")
    b = params01.shape[0]
    noise = make_noise(config, params01.device, b) if noise is None else noise[:b]
    if bwd == "jnp" and torch.is_grad_enabled() and params01.requires_grad:
        return _PortableRenderGrad.apply(params01, noise, config)
    return _render_fused(params01, config, noise)


def render_fused_with_noise(
    params01: torch.Tensor, config: SynthConfig, noise: torch.Tensor
) -> torch.Tensor:
    """The fused render with a caller-provided noise buffer: a named alias of
    ``render_voice_fused(noise=...)``, as the JAX package keeps it."""
    return render_voice_fused(params01, config, noise)


def render_voice_auto(
    params01: torch.Tensor,
    config: SynthConfig,
    noise: Optional[torch.Tensor] = None,
    bwd: str = "pallas",
) -> torch.Tensor:
    """The fused render where the geometry allows, else ``render_voice``."""
    if fused_render_available(config):
        return render_voice_fused(params01, config, noise, bwd)
    return render_voice(params01, config, noise)


def sample_voice_params(batch_num: int, config: SynthConfig, device=None) -> torch.Tensor:
    """Deterministic per-batch-number parameter draw: [B, 78] uniform in [0, 1),
    bit-identical to the JAX package's draw for the same batch number."""
    key = prng.fold_in(prng.prng_key(config.seed), int(batch_num))
    return prng.uniform(key, (config.batch_size, len(VOICE_PARAM_SPECS)), device=device)


def is_train_split(batch_num: int, config: SynthConfig, device=None) -> torch.Tensor:
    """synth1B1-style train/test flag ([B] bool): every 10th batch is test."""
    train = (int(batch_num) % 10) != 0
    return torch.full((config.batch_size,), train, dtype=torch.bool, device=device)


_INDEX = {(s.module, s.name): i for i, s in enumerate(VOICE_PARAM_SPECS)}


class Voice:
    """Stateful wrapper with the torchsynth call surface.

    ``voice(batch_num)`` -> (audio [B, Ta], params01 [B, 78], is_train [B]);
    ``voice(None)`` after ``set_parameter_0to1``/``freeze_parameters``
    resynthesizes from the parameters set. Renders with ``render_voice_auto``
    (the fused render where the geometry allows: the CUDA kernel on a CUDA
    device) from a noise buffer made once. The computation underneath is
    ``sample_voice_params``/``render_voice_auto``; training code calls those.
    """

    def __init__(self, synthconfig: SynthConfig, device="cuda"):
        self.synthconfig = synthconfig
        self.device = torch.device(device)
        n = len(VOICE_PARAM_SPECS)
        self._params01 = torch.full((synthconfig.batch_size, n), 0.5, device=self.device)
        self._frozen_mask = torch.zeros((n,), dtype=torch.bool, device=self.device)
        self._noise = make_noise(synthconfig, self.device)

    # -- torchsynth-style parameter addressing --------------------------------
    def get_parameters(self) -> "OrderedDict[Tuple[str, str], torch.Tensor]":
        return OrderedDict(
            ((s.module, s.name), self._params01[:, i]) for i, s in enumerate(VOICE_PARAM_SPECS)
        )

    def set_parameter_0to1(self, module: str, name: str, value) -> None:
        params01 = self._params01.clone()  # tensors handed out earlier keep their values
        params01[:, _INDEX[(module, name)]] = torch.as_tensor(value, dtype=torch.float32)
        self._params01 = params01

    def set_all_parameters_0to1(self, params01) -> None:
        params01 = torch.as_tensor(params01, dtype=torch.float32, device=self.device)
        if params01.shape != self._params01.shape:
            raise ValueError(f"params01 must be {tuple(self._params01.shape)}, got {tuple(params01.shape)}")
        self._params01 = params01.clone()

    def freeze_parameters(self, keys=None) -> None:
        """Keep the set values of these parameters through later ``voice(batch_num)``
        calls. ``keys`` is an iterable of (module, name); None freezes all 78.
        Repeated calls accumulate, like torchsynth's per-parameter flags."""
        if keys is None:
            self._frozen_mask = torch.ones_like(self._frozen_mask)
            return
        mask = self._frozen_mask.clone()
        mask[[_INDEX[tuple(k)] for k in keys]] = True
        self._frozen_mask = mask

    def unfreeze_all_parameters(self) -> None:
        self._frozen_mask = torch.zeros_like(self._frozen_mask)

    # -- synthesis -------------------------------------------------------------
    def __call__(
        self, batch_num: Optional[int]
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        b = self.synthconfig.batch_size
        if batch_num is not None and not bool(self._frozen_mask.all()):
            fresh = sample_voice_params(batch_num, self.synthconfig, self.device)
            # frozen parameters survive the resample (per-key torchsynth semantics)
            self._params01 = torch.where(self._frozen_mask[None, :], self._params01, fresh)
            is_train = is_train_split(batch_num, self.synthconfig, self.device)
        else:
            is_train = torch.ones((b,), dtype=torch.bool, device=self.device)
        audio = render_voice_auto(self._params01, self.synthconfig, self._noise)
        return audio, self._params01, is_train
