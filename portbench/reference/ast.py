"""The Audio Spectrogram Transformer (AST) audio tower, its VICReg model and its
pretraining steps, in plain float32 torch.

Gong, Chung and Glass, "AST: Audio Spectrogram Transformer" (arXiv:2104.01778);
github.com/YuanGongND/ast ``src/models/ast_models.py`` ``ASTModel(model_size=
'base384', fstride=10, tstride=10, input_fdim=128)``, front end from
``src/dataloader.py``. The layer equations, as published:

- Front end: torchaudio's ``kaldi.fbank(waveform, htk_compat=True,
  sample_frequency=rate, use_energy=False, window_type='hanning',
  num_mel_bins=128, dither=0.0, frame_shift=10)`` after subtracting the
  waveform's mean. Frames of int(rate x 25 ms) samples every int(rate x 10 ms)
  (snip_edges: only whole frames); each frame's mean subtracted; pre-emphasis
  x[j] - 0.97 x[max(j - 1, 0)]; a symmetric Hann window 0.5 - 0.5 cos(2 pi n /
  (N - 1)); zero-padded to the next power of two; |rfft|^2; Kaldi's triangular
  mel banks, mel(f) = 1127 ln(1 + f / 700), from 20 Hz to Nyquist with
  num_bins + 2 equally spaced mel edges, over the FFT bins below Nyquist (the
  Nyquist bin weighted 0); log(max(., float32 eps)). Then zero-padded or cut to
  ``input_tdim`` frames and normalised (x - norm_mean) / (2 norm_std).
- Patches: Conv2d(1, D, 16, stride=(fstride, tstride)) on the [B, 1, F, T]
  image, flattened frequency-major; cls_token and dist_token in front; a
  learned pos_embed added.
- Each of ``depth`` blocks: x = x + proj(attn(LN1(x))); x = x + fc2(GELU(fc1(LN2(x))));
  LayerNorm eps 1e-6 (E[(x - mean)^2], biased); qkv one Linear(D, 3D) with a
  bias, split into heads of D / num_heads; attn = softmax(q k^T / sqrt(head
  dim)) v, written out; GELU by erf; no dropout, no drop-path.
- Output: LayerNorm (eps 1e-6); (x[:, 0] + x[:, 1]) / 2; mlp_head = LayerNorm
  (eps 1e-5) and Linear(D, dim).

The parameter names are AST's and the measured package's. The Linear layers,
the patch convolution and the products inside attention go through
``towers.py``'s ``Linear``, ``Conv`` and ``matmul``, so the float8 control
rounds them where the program computes in bf16 (the attention output too) and
``counts/model_flops.py`` sees the layers; the front end, LayerNorm, softmax
and the residual stream stay float32 there as in the program.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from . import synth as S
from . import towers as T
from .lars import lars_step, learning_rate
from .train import _dropout_generator, _load, _rounded

PREEMPHASIS = 0.97
LOW_FREQ = 20.0


def frame_geometry(rate: float, frame_length_ms: float, frame_shift_ms: float):
    """(window, shift, FFT size) in samples."""
    size = int(rate * frame_length_ms * 0.001)
    shift = int(rate * frame_shift_ms * 0.001)
    n_fft = 1
    while n_fft < size:
        n_fft *= 2
    return size, shift, n_fft


def mel_banks(num_bins: int, n_fft: int, rate: float, device=None) -> torch.Tensor:
    """[num_bins, n_fft // 2 + 1] float32 triangular weights, built in float64."""
    def mel(f):
        return 1127.0 * torch.log(1.0 + f / 700.0)

    lo = mel(torch.tensor(LOW_FREQ, dtype=torch.float64))
    hi = mel(torch.tensor(rate / 2.0, dtype=torch.float64))
    edges = lo + torch.arange(num_bins + 2, dtype=torch.float64) * (hi - lo) / (num_bins + 1)
    out = torch.zeros(num_bins, n_fft // 2 + 1, dtype=torch.float64)
    m = mel(torch.arange(n_fft // 2, dtype=torch.float64) * rate / n_fft)
    for i in range(num_bins):
        left, center, right = edges[i], edges[i + 1], edges[i + 2]
        rising = (m - left) / (center - left)
        falling = (right - m) / (right - center)
        out[i, : n_fft // 2] = torch.clamp(torch.minimum(rising, falling), min=0.0)
    return out.float().to(device)


def fbank(audio: torch.Tensor, rate: float, num_bins: int, frame_length_ms: float,
          frame_shift_ms: float) -> torch.Tensor:
    """[B, T] audio -> [B, frames, num_bins] log mel energies, float32."""
    size, shift, n_fft = frame_geometry(rate, frame_length_ms, frame_shift_ms)
    device = audio.device
    x = audio.float()
    x = x - x.mean(dim=1, keepdim=True)
    n_frames = 1 + (x.shape[1] - size) // shift
    index = torch.arange(n_frames, device=device)[:, None] * shift + torch.arange(size, device=device)[None, :]
    frames = x[:, index]  # [B, frames, size]
    frames = frames - frames.mean(dim=2, keepdim=True)
    before = torch.clamp(torch.arange(size, device=device) - 1, min=0)
    frames = frames - PREEMPHASIS * frames[:, :, before]
    n = torch.arange(size, dtype=torch.float64, device=device)
    window = (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / (size - 1))).float()
    padded = torch.cat([frames * window, frames.new_zeros(*frames.shape[:2], n_fft - size)], dim=2)
    spectrum = torch.fft.rfft(padded)
    power = spectrum.real ** 2 + spectrum.imag ** 2
    energies = power @ mel_banks(num_bins, n_fft, rate, device).T
    return torch.log(torch.maximum(energies, torch.tensor(torch.finfo(torch.float32).eps, device=device)))


class LayerNorm(nn.Module):
    def __init__(self, n: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = T.Linear(dim, 3 * dim)
        self.proj = T.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        hd = c // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [B, heads, N, head dim]
        scores = T.matmul(q, k.transpose(-2, -1)) / math.sqrt(hd)
        out = T._round(T.matmul(torch.softmax(scores, dim=-1), v))
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = T.Linear(dim, hidden)
        self.fc2 = T.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim, 1e-6)
        self.mlp = Mlp(dim, mlp_dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int, stride):
        super().__init__()
        self.proj = T.Conv(1, dim, patch, stride=stride)


class ViT(nn.Module):
    def __init__(self, dim, depth, num_heads, mlp_dim, patch, stride, tokens):
        super().__init__()
        self.patch_embed = PatchEmbed(dim, patch, stride)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim))
        self.blocks = nn.ModuleList(Block(dim, num_heads, mlp_dim) for _ in range(depth))
        self.norm = LayerNorm(dim, 1e-6)


class AST(nn.Module):
    """[B, 1, T] audio -> [B, dim]; the keyword arguments are ``audio_tower.ast``'s."""

    def __init__(self, dim: int, rate: float, input_fdim: int, input_tdim: int, frame_length_ms: float,
                 frame_shift_ms: float, patch_size: int, fstride: int, tstride: int, embed_dim: int,
                 depth: int, num_heads: int, mlp_dim: int, norm_mean: float, norm_std: float):
        super().__init__()
        self.rate, self.input_fdim, self.input_tdim = rate, input_fdim, input_tdim
        self.frame_length_ms, self.frame_shift_ms = frame_length_ms, frame_shift_ms
        self.norm_mean, self.norm_std = norm_mean, norm_std
        tokens = 2 + ((input_fdim - patch_size) // fstride + 1) * ((input_tdim - patch_size) // tstride + 1)
        self.v = ViT(embed_dim, depth, num_heads, mlp_dim, patch_size, (fstride, tstride), tokens)
        self.mlp_head = nn.Sequential(LayerNorm(embed_dim, 1e-5), T.Linear(embed_dim, dim))

    def features(self, audio):
        """[B, 1, T] -> [B, input_tdim, input_fdim]: the normalised fbank."""
        x = fbank(audio[:, 0], self.rate, self.input_fdim, self.frame_length_ms, self.frame_shift_ms)
        if x.shape[1] < self.input_tdim:
            x = torch.cat([x, x.new_zeros(x.shape[0], self.input_tdim - x.shape[1], x.shape[2])], dim=1)
        return (x[:, : self.input_tdim] - self.norm_mean) / (2.0 * self.norm_std)

    def encode(self, features):
        """[B, input_tdim, input_fdim] -> [B, dim]."""
        v = self.v
        x = v.patch_embed.proj(features.transpose(1, 2)[:, None])  # [B, D, grid f, grid t]
        x = x.flatten(2).transpose(1, 2)
        b = x.shape[0]
        x = torch.cat([v.cls_token.expand(b, -1, -1), v.dist_token.expand(b, -1, -1), x], dim=1) + v.pos_embed
        for blk in v.blocks:
            x = blk(x)
        x = v.norm(x)
        return self.mlp_head((x[:, 0] + x[:, 1]) / 2)

    def forward(self, audio):
        return self.encode(self.features(audio))


def ast_kwargs(cfg) -> Dict:
    return dict(cfg["audio_tower"]["ast"])


class VICReg(nn.Module):
    """The AST audio tower, towers.py's parameter tower and projector."""

    def __init__(self, cfg):
        super().__init__()
        dims = tuple(int(v) for v in (f"{cfg['dim']}-" + cfg["vicreg"]["mlp"] % cfg["embeddim"]).split("-"))
        self.backbone_audio = AST(cfg["dim"], cfg["torchsynth"]["rate"], **ast_kwargs(cfg))
        self.backbone_param = T.ParamEmbed(cfg["nparams"], cfg["dim"], cfg["param_embed"]["dropout"])
        self.projector = T.Projector(dims)

    def forward(self, audio, params):
        return self.projector(self.backbone_audio(audio)), self.projector(self.backbone_param(params))


def layer_norm_scales(model: nn.Module) -> List[str]:
    """The names of every LayerNorm scale of ``model``."""
    return [f"{prefix}.weight" for prefix, m in model.named_modules() if isinstance(m, LayerNorm)]


def pretrain(cfg, weights: Dict[str, torch.Tensor], batch_nums: List[int], device) -> Dict:
    """The VICReg steps for ``batch_nums`` from ``weights``, as ``train.pretrain``
    takes them, with the AST audio tower."""
    v = cfg["vicreg"]
    synth = S.synth_from_cfg(cfg, v["batch_size"])
    noise = S.noise_rows(synth, synth.batch_size, device)
    model = VICReg(cfg).to(device)
    _load(model, weights)
    _dropout_generator(model, int(cfg["seed"]) + 1, device)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    out = {"loss": [], "repr_loss": [], "std_loss": [], "cov_loss": []}
    for count, n in enumerate(batch_nums):
        model.train()
        params01 = S.voice_params(n, synth, device)
        audio = S.render_blocks(params01, synth, noise)
        x, y = model(audio[:, None, :], params01)
        if count == 0:
            out["embed"] = [x.detach().float().cpu(), y.detach().float().cpu()]
        loss, r, s, c = T.vicreg_loss(x, y, v["sim_coeff"], v["std_coeff"], v["cov_coeff"])
        grads = _rounded(torch.autograd.grad(loss, params))
        if count == 0:
            out["grad"] = {nm: g.detach().clone() for nm, g in zip(names, grads)}
        for key, val in zip(("loss", "repr_loss", "std_loss", "cov_loss"), (loss, r, s, c)):
            out[key].append(float(val.detach()))
        lr = learning_rate(v["optim"], v.get("scheduler"), v["batch_size"], count)
        lars_step(params, list(grads), lr, float(v["optim"]["args"].get("weight_decay", 0.0)))
    out["params"] = {nm: p.detach() for nm, p in zip(names, params)}
    return out
