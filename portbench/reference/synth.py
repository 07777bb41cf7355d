"""The Voice synthesizer in plain float32 torch: batch number -> parameters -> audio.

The benchmark's own frozen copy of the synth's equations, so that the yardstick
does not move when the program does. It follows the torchsynth-1.0 Voice patch
as the measured package describes it: threefry-2x32 draws keyed by the batch
number (the layout of ``jax.random`` with partitionable threefry), curve-warped
parameter ranges, ADSR envelopes and rate-modulated LFOs at the control rate, a
4 x 5 modulation matrix, a sine VCO and a tanh square/saw VCO whose phase is
integrated by control-rate segments in one fixed order of sums, fixed-seed
noise, VCAs and a 3-channel mixer. Every elementwise function is the exactly
rounded float32 sequence (Horner polynomials, Cody-Waite reduction), so the
same inputs give the same audio on the CPU and on the card. Differentiable in
the parameters by autograd.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# -- threefry-2x32 --------------------------------------------------------------------

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed: int) -> torch.Tensor:
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    a, b = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def uniform(key: torch.Tensor, shape: Sequence[int], lo: float = 0.0, hi: float = 1.0,
            device=None) -> torch.Tensor:
    """Uniform float32 in [lo, hi) from the 64-bit flat index of each element;
    ``key`` may carry leading dims (one key each)."""
    device = key.device if device is None else torch.device(device)
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(tuple(shape))
    key = key.to(device)
    lead = key.shape[:-1] + (1,) * len(shape)
    b1, b2 = threefry2x32(key[..., 0].reshape(lead), key[..., 1].reshape(lead), idx >> 32, idx & _MASK)
    bits = b1 ^ b2
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo32, hi32 = float(np.float32(lo)), float(np.float32(hi))
    return torch.clamp_min(floats * float(np.float32(hi32 - lo32)) + lo32, lo32)


# -- configuration and parameter ranges ---------------------------------------------


@dataclass(frozen=True)
class Synth:
    batch_size: int
    sample_rate: int = 44100
    buffer_size_seconds: float = 4.0
    control_rate: int = 441
    seed: int = 0
    noise_seed: int = 13

    @property
    def buffer_size(self) -> int:
        return int(round(self.buffer_size_seconds * self.sample_rate))

    @property
    def control_buffer_size(self) -> int:
        return int(round(self.buffer_size_seconds * self.control_rate))


@dataclass(frozen=True)
class Spec:
    module: str
    name: str
    lo: float
    hi: float
    curve: float = 1.0
    symmetric: bool = False


def _adsr(m):
    return [Spec(m, "attack", 0, 2, 0.5), Spec(m, "decay", 0, 2, 0.5), Spec(m, "sustain", 0, 1),
            Spec(m, "release", 0, 5, 0.5), Spec(m, "alpha", 0.1, 6)]


def _lfo(m):
    return [Spec(m, "frequency", 0, 20, 0.25), Spec(m, "mod_depth", -10, 20, 0.5, True),
            Spec(m, "initial_phase", -math.pi, math.pi)] + [Spec(m, s, 0, 1) for s in ("sin", "tri", "saw", "rsaw", "sqr")]


MOD_IN = ("adsr_1", "adsr_2", "lfo_1", "lfo_2")
MOD_OUT = ("vco_1_pitch", "vco_1_amp", "vco_2_pitch", "vco_2_amp", "noise_amp")
SPECS: Tuple[Spec, ...] = tuple(
    [Spec("keyboard", "midi_f0", 0, 127), Spec("keyboard", "duration", 0.01, 4, 0.5)]
    + _adsr("adsr_1") + _adsr("adsr_2") + _lfo("lfo_1") + _lfo("lfo_2")
    + _adsr("lfo_1_amp_adsr") + _adsr("lfo_2_amp_adsr") + _adsr("lfo_1_rate_adsr") + _adsr("lfo_2_rate_adsr")
    + [Spec("mod_matrix", f"{i}->{o}", 0, 1, 0.5) for i in MOD_IN for o in MOD_OUT]
    + [Spec("vco_1", "tuning", -24, 24), Spec("vco_1", "mod_depth", -96, 96, 0.2, True),
       Spec("vco_1", "initial_phase", -math.pi, math.pi),
       Spec("vco_2", "tuning", -24, 24), Spec("vco_2", "mod_depth", -96, 96, 0.2, True),
       Spec("vco_2", "initial_phase", -math.pi, math.pi), Spec("vco_2", "shape", 0, 1),
       Spec("mixer", "vco_1", 0, 1), Spec("mixer", "vco_2", 0, 1), Spec("mixer", "noise", 0, 1, 0.025)]
)
assert len(SPECS) == 78


def voice_params(batch_num: int, synth: Synth, device) -> torch.Tensor:
    """[B, 78] uniform parameters of a batch number: ``uniform(fold_in(key(seed), n))``."""
    key = fold_in(prng_key(synth.seed), int(batch_num))
    return uniform(key, (synth.batch_size, len(SPECS)), device=device)


def noise_rows(synth: Synth, rows: int, device, row_offset: int = 0) -> torch.Tensor:
    """Fixed white noise in [-1, 1): row i is ``uniform(fold_in(key(noise_seed), i))``."""
    keys = fold_in(prng_key(synth.noise_seed), row_offset + torch.arange(rows, dtype=torch.int64))
    out = torch.empty((rows, synth.buffer_size), dtype=torch.float32, device=device)
    step = max(1, (1 << 22) // synth.buffer_size)
    for i in range(0, rows, step):
        out[i:i + step] = uniform(keys[i:i + step], (synth.buffer_size,), -1.0, 1.0, device=device)
    return out


def _safe_pow(base, exponent):
    pos = base > 0.0
    return torch.where(pos, torch.pow(torch.where(pos, base, torch.ones_like(base)), exponent),
                       torch.zeros_like(base))


def natural(params01: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for i, s in enumerate(SPECS):
        x = params01[:, i]
        if not s.symmetric:
            v = s.lo + (s.hi - s.lo) * (_safe_pow(x, s.curve) if s.curve != 1.0 else x)
        else:
            d = 2.0 * x - 1.0
            v = s.lo + (s.hi - s.lo) * (torch.sign(d) * _safe_pow(torch.abs(d), s.curve) + 1.0) / 2.0
        out.setdefault(s.module, {})[s.name] = v
    return out


# -- exactly rounded float32 elementwise functions ----------------------------------

EXP2 = (0.00015332508, 0.0013394702, 0.009618491, 0.055503424, 0.24022648, 0.6931472, 1.0)
PIO2 = (1.5703125, 4.837512969970703e-04, 7.549790126404332e-08)
SIN = (2.7183114939898219064e-06, -1.98393348360966317347e-04, 8.3333293858894631756e-03,
       -1.66666666416265235595e-01)
COS = (2.43904487962774090654e-05, -1.38867637746099294692e-03, 4.16666233237390631894e-02,
       -4.99999997251031003120e-01)
TWO_PI = 2.0 * math.pi


def exp2(x):
    x = x.float()
    n = torch.floor(x + 0.5)
    f = x - n
    p = torch.full_like(f, EXP2[0])
    for c in EXP2[1:]:
        p = p * f + c
    return p * ((n.to(torch.int32) + 127) << 23).view(torch.float32)


def sincos(x):
    x = x.float()
    n = torch.floor(x * 0.6366197723675814 + 0.5)
    q = x - n * PIO2[0]
    q = q - n * PIO2[1]
    q = q - n * PIO2[2]
    z = q * q
    ps = torch.full_like(z, SIN[0])
    for c in SIN[1:]:
        ps = ps * z + c
    s = q + q * (z * ps)
    pc = torch.full_like(z, COS[0])
    for c in COS[1:]:
        pc = pc * z + c
    c = 1.0 + z * pc
    k = n.to(torch.int32) & 3

    def pick(a, b, cc, d):
        return torch.where(k == 0, a, torch.where(k == 1, b, torch.where(k == 2, cc, d)))

    return pick(s, c, -s, -c), pick(c, -s, -c, s)


def tanh(x):
    x = torch.minimum(torch.maximum(x.float(), x.new_full((), -43.0)), x.new_full((), 43.0))
    y = exp2(x * 2.885390081777927)
    return (y - 1.0) / (y + 1.0)


def maximum(x, lo):
    return torch.maximum(x, torch.full((), lo, dtype=x.dtype, device=x.device))


def clip(x, lo, hi):
    return torch.minimum(maximum(x, lo), torch.full((), hi, dtype=x.dtype, device=x.device))


def fmod_floor(x, y):
    r = torch.fmod(x, y)
    return torch.where((r != 0) & (r < 0), r + y, r)


# -- the Voice graph ------------------------------------------------------------------


def _ramp(n, rate, duration, alpha, start=None, inverse=False):
    t = torch.arange(n, dtype=torch.float32, device=duration.device)[None, :]
    st = 0.0 if start is None else (start * rate)[:, None]
    y = clip((t - st) / maximum((duration * rate)[:, None], 1e-9), 0.0, 1.0)
    if inverse:
        y = 1.0 - y
    return _safe_pow(y, alpha[:, None])


def adsr(p, note_on, n, rate):
    attack = torch.minimum(p["attack"], note_on)
    decay = torch.minimum(maximum(note_on - p["attack"], 0.0), p["decay"])
    sustain = p["sustain"][:, None]
    return (_ramp(n, rate, attack, p["alpha"])
            * ((1.0 - sustain) * _ramp(n, rate, decay, p["alpha"], start=attack, inverse=True) + sustain)
            * _ramp(n, rate, p["release"], p["alpha"], start=note_on, inverse=True))


def lfo(p, rate_mod, rate):
    freq = maximum(p["frequency"][:, None] + p["mod_depth"][:, None] * rate_mod, 0.0)
    arg = torch.cumsum((2.0 * math.pi * freq / rate).double(), dim=1).float() + p["initial_phase"][:, None]
    cos = (torch.cos(arg + math.pi) + 1.0) / 2.0
    square = (torch.sign(torch.cos(arg + math.pi)) + 1.0) / 2.0
    saw = fmod_floor(arg, TWO_PI) / TWO_PI
    tri = 2.0 * saw
    tri = torch.where(tri > 1.0, 2.0 - tri, tri)
    shapes = torch.stack([cos, tri, saw, 1.0 - saw, square], dim=1)
    w = torch.pow(torch.stack([p[s] for s in ("sin", "tri", "saw", "rsaw", "sqr")], dim=1), math.e)
    w = w / maximum(w.sum(dim=1, keepdim=True), 1e-9)
    return torch.einsum("bs,bst->bt", w, shapes)


def controls(params01: torch.Tensor, synth: Synth):
    """(natural parameters, routed controls [B, 5, Tc], midi_f0 [B])."""
    cr, tc = float(synth.control_rate), synth.control_buffer_size
    p = natural(params01.float())
    note_on = p["keyboard"]["duration"]

    def env(m):
        return adsr(p[m], note_on, tc, cr)

    l1 = lfo(p["lfo_1"], env("lfo_1_rate_adsr"), cr) * maximum(env("lfo_1_amp_adsr"), 0.0)
    l2 = lfo(p["lfo_2"], env("lfo_2_rate_adsr"), cr) * maximum(env("lfo_2_amp_adsr"), 0.0)
    mods = torch.stack([env("adsr_1"), env("adsr_2"), l1, l2], dim=1)
    w = torch.stack([torch.stack([p["mod_matrix"][f"{i}->{o}"] for o in MOD_OUT], 1) for i in MOD_IN], 1)
    return p, torch.einsum("bio,bit->bot", w, mods), p["keyboard"]["midi_f0"]


def _midi_to_hz(m):
    return 440.0 * exp2((m - 69.0) / 12.0)


def scalars(p, midi_f0) -> torch.Tensor:
    """The per-voice scalars of the audio-rate half, [B, 11]: pitch base, depth and
    initial phase of each oscillator, the square/saw shape and band-limit
    partials, the three mixer levels."""
    v1, v2 = p["vco_1"], p["vco_2"]
    max_f0 = _midi_to_hz(midi_f0 + v2["tuning"] + maximum(v2["mod_depth"], 0.0))
    partials = 12000.0 / maximum(max_f0 * torch.log10(maximum(max_f0, 1.0 + 1e-6)), 1e-9)
    return torch.stack([midi_f0 + v1["tuning"], v1["mod_depth"], v1["initial_phase"],
                        midi_f0 + v2["tuning"], v2["mod_depth"], v2["initial_phase"], v2["shape"],
                        partials, p["mixer"]["vco_1"], p["mixer"]["vco_2"], p["mixer"]["noise"]], dim=1)


# The audio-rate half integrates each oscillator's phase by control-rate
# segments of ``ratio`` samples, in tiles of 32 segments: a segment's mean
# increment times the sample's position plus the running residual, plus the
# segment's offset, all wrapped at 2 pi. The sums are taken in one fixed order
# (8 lanes of ceil(ratio / 8) samples per segment, lane sums by butterfly, lane
# and tile prefixes by Hillis-Steele scans, tiles chained in order), so the
# audio does not depend on the batch or the device beyond float32 rounding.
LANES, TILE = 8, 32


def _div(x, d):
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _scan(x):
    off = 1
    while off < x.shape[-1]:
        x = torch.cat([x[..., :off], x[..., off:] + x[..., :-off]], dim=-1)
        off *= 2
    return x


def _butterfly_sum(x):
    lane = torch.arange(x.shape[-1], device=x.device)
    m = x.shape[-1] // 2
    while m >= 1:
        x = x + x[..., lane ^ m]
        m //= 2
    return x[..., 0]


def _segment_phase(dphi, holds, ratio):
    zero = dphi.new_zeros(())
    run = dphi.shape[-1]
    lane_sum = torch.zeros_like(dphi[..., 0])
    for i in range(run):
        lane_sum = lane_sum + torch.where(holds[:, i], dphi[..., i], zero)
    mean = _div(_butterfly_sum(lane_sum), float(ratio))
    res = torch.zeros_like(lane_sum)
    own = []
    for i in range(run):
        res = res + torch.where(holds[:, i], dphi[..., i] - mean[..., None], zero)
        own.append(res)
    incl = _scan(res)
    ex = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], dim=-1)
    last = (ratio - 1) // run
    total = fmod_floor(mean * float(ratio) + (ex[..., last] + res[..., last]), TWO_PI)
    return mean, torch.stack([ex + q for q in own], dim=-1), total


def _strict_clamp(x, lo=None, hi=None):
    """clamp's values, with the gradient passed only strictly inside the range
    (the render's backward masks: u > 0, 0 < pitch < 127)."""
    inside = torch.ones_like(x, dtype=torch.bool)
    if lo is not None:
        inside = inside & (x > lo)
    if hi is not None:
        inside = inside & (x < hi)
    return torch.where(inside, x, torch.clamp(x, lo, hi).detach())


def render_audio(routed, sc, noise, sample_rate: float, strict_masks: bool = False) -> torch.Tensor:
    """routed [B, 5, Tc], scalars [B, 11], noise [B, Ta] -> audio [B, Ta].
    ``strict_masks``: the same values, with clamps that pass no gradient at a
    tie (the render kernel's backward); else autograd's clamp gradient."""
    b, _, tc = routed.shape
    ta = noise.shape[-1]
    r = ta // tc
    run = -(-r // LANES)
    n_tiles = -(-tc // TILE)
    tcp = n_tiles * TILE
    dev = routed.device
    seg = torch.arange(tcp, device=dev)
    left = routed[..., seg.clamp(max=tc - 1)]
    prev = routed[..., (seg - 1).clamp(0, tc - 1)]
    nxt = routed[..., (seg + 1).clamp(max=tc - 1)]
    j = torch.arange(LANES * run, device=dev).reshape(LANES, run)
    holds = j < r
    jw = _div(j.to(torch.float32) + 0.5, float(r)) - 0.5
    w = torch.abs(jw)
    ramp = j.to(torch.float32) + 1.0

    def up(i):  # control i at the samples: [B, tcp, LANES, run]
        neighbour = torch.where(jw < 0.0, prev[:, i, :, None, None], nxt[:, i, :, None, None])
        return left[:, i, :, None, None] * (1.0 - w) + neighbour * w

    def col(i):
        return sc[:, i][:, None, None, None]

    scale = float(np.float32(2.0 * math.pi / float(sample_rate)))

    clamp = _strict_clamp if strict_masks else torch.clamp

    def phase(i, base, depth):
        midi = clamp(base + depth * up(i), 0.0, 127.0)
        dphi = scale * (440.0 * exp2(_div(midi - 69.0, 12.0)))
        mean, prefix, total = _segment_phase(dphi, holds, r)
        incl = _scan(total.reshape(b, n_tiles, TILE))
        excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], dim=-1)
        tile_total = fmod_floor(incl[..., -1], TWO_PI)
        carry, acc = [torch.zeros_like(tile_total[..., 0])], torch.zeros_like(tile_total[..., 0])
        for k in range(n_tiles - 1):
            acc = fmod_floor(acc + tile_total[..., k], TWO_PI)
            carry.append(acc)
        offset = fmod_floor(fmod_floor(excl, TWO_PI) + torch.stack(carry, -1)[..., None], TWO_PI).reshape(b, tcp)
        return (mean[..., None, None] * ramp + prefix) + offset[..., None, None]

    _, cos1 = sincos(phase(0, col(0), col(1)) + col(2))
    mix = col(8) * cos1 * clamp(up(1), 0.0)
    sin2, cos2 = sincos(phase(2, col(3), col(4)) + col(5))
    shape = col(6)
    osc2 = (1.0 - shape / 2.0) * tanh(math.pi * col(7) * sin2 / 2.0) * (1.0 + shape * cos2)
    mix = mix + col(9) * osc2 * clamp(up(3), 0.0)
    slots = F.pad(noise.reshape(b, -1), (0, tcp * r - ta)).reshape(b, tcp, r)
    slots = F.pad(slots, (0, LANES * run - r)).reshape(b, tcp, LANES, run)
    mix = mix + col(10) * slots * clamp(up(4), 0.0)
    return mix.reshape(b, tcp, LANES * run)[..., :r].reshape(b, tcp * r)[:, :ta]


def render(params01: torch.Tensor, synth: Synth, noise: torch.Tensor, strict_masks: bool = False) -> torch.Tensor:
    """[B, 78] parameters -> [B, Ta] audio; ``noise`` holds the batch's noise rows."""
    p, routed, midi_f0 = controls(params01, synth)
    return render_audio(routed, scalars(p, midi_f0), noise[: params01.shape[0]], float(synth.sample_rate),
                        strict_masks)


def render_blocks(params01: torch.Tensor, synth: Synth, noise: torch.Tensor, rows: int = 128) -> torch.Tensor:
    """``render`` without a gradient, in blocks of ``rows`` voices to bound memory."""
    with torch.no_grad():
        return torch.cat([render(params01[i:i + rows], synth, noise[i:i + rows])
                          for i in range(0, params01.shape[0], rows)])


def synth_from_cfg(cfg, batch_size: int, seed: Optional[int] = None) -> Synth:
    t = cfg["torchsynth"]
    return Synth(batch_size=batch_size, sample_rate=t["rate"], buffer_size_seconds=t["buffer_size_seconds"],
                 control_rate=t.get("control_rate", 441), seed=cfg["seed"] if seed is None else seed)
