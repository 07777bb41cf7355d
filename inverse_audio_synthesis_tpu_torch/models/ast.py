"""Audio tower: audio -> Kaldi log-mel fbank -> Audio Spectrogram Transformer -> [B, dim].

The Audio Spectrogram Transformer (AST) of Gong, Chung and Glass, "AST: Audio
Spectrogram Transformer" (arXiv:2104.01778): ``ASTModel(model_size='base384',
fstride=10, tstride=10, input_fdim=128)`` of github.com/YuanGongND/ast
(``src/models/ast_models.py``), with the front end of its ``src/dataloader.py``.

- Front end (``kaldi_fbank``, float32, outside autocast): torchaudio's
  ``kaldi.fbank`` with AST's arguments (``htk_compat``, no energy, Hann window,
  no dither, ``snip_edges``): the waveform's mean subtracted; frames of
  ``frame_length_ms`` every ``frame_shift_ms``; each frame's mean subtracted;
  pre-emphasis 0.97 with the first sample replicated; a symmetric Hann window;
  zero-padded to the next power of two; ``|rfft|^2``; Kaldi's triangular mel
  banks on ``1127 ln(1 + f/700)`` from 20 Hz to Nyquist (the Nyquist bin
  weighted 0); ``log(max(., float32 eps))``. Then zero-padded or cut to
  ``input_tdim`` frames and normalised with AST's AudioSet constants,
  ``(x - norm_mean) / (2 norm_std)``. 4 s at 44.1 kHz: a 1,102-sample window
  every 441 samples, a 2,048-point FFT, 398 frames, padded to 400.
- Patches: ``Conv2d(1, embed_dim, patch_size, stride=(fstride, tstride))`` on the
  [B, 1, input_fdim, input_tdim] image (128 x 400: a 12 x 39 grid, 468 patches,
  flattened frequency-major); ``cls_token`` and ``dist_token`` in front; a
  learned ``pos_embed`` added.
- ``depth`` DeiT blocks: ``x + proj(attn(LN1(x)))``, then ``x + fc2(GELU(fc1(LN2(x))))``;
  LayerNorm eps 1e-6; ``qkv`` one Linear with bias, ``num_heads`` heads;
  ``softmax(q k^T / sqrt(head dim)) v``; erf GELU; no dropout or drop-path.
- Output: LayerNorm (eps 1e-6), the mean of the two class tokens, then
  ``mlp_head``: LayerNorm (eps 1e-5) and Linear(embed_dim, dim).

The parameter names are AST's (``v.patch_embed.proj``, ``v.cls_token``,
``v.dist_token``, ``v.pos_embed``, ``v.blocks.{i}.norm1``, ``.attn.qkv``,
``.attn.proj``, ``.norm2``, ``.mlp.fc1``, ``.mlp.fc2``, ``v.norm``,
``mlp_head.0``, ``mlp_head.1``), so a converted AST checkpoint loads by name.
The residual stream is float32; under bf16 autocast the Linear layers, the patch
convolution and the attention run in bf16 and LayerNorm in float32.

Attention is ``F.scaled_dot_product_attention``. On CUDA it runs under
``sdpa_kernel`` with the fused backends alone (cuDNN, flash, memory-efficient):
a call none of them takes raises instead of falling back to the math path. On
the CPU it runs the math path. Under a profiler the front end is the span
``tower/frontend`` and the rest ``tower/encoder``. Counters:
``tokens_per_voice`` and ``sdpa_backends`` (of the device the weights are on).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from inverse_audio_synthesis_tpu_torch.models.layers import Linear, conv2d
from inverse_audio_synthesis_tpu_torch.utils.profiling import span

PREEMPHASIS = 0.97
LOW_FREQ = 20.0
FUSED_BACKENDS = (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION)


def frame_geometry(sample_rate: float, frame_length_ms: float, frame_shift_ms: float) -> Tuple[int, int, int]:
    """(window, shift, FFT size) in samples, as Kaldi rounds them."""
    window = int(sample_rate * frame_length_ms * 0.001)
    shift = int(sample_rate * frame_shift_ms * 0.001)
    return window, shift, 1 << (window - 1).bit_length()


def kaldi_mel_banks(num_bins: int, n_fft: int, sample_rate: float) -> np.ndarray:
    """[num_bins, n_fft // 2 + 1] float64 triangular banks on Kaldi's mel scale
    from LOW_FREQ to Nyquist; the Nyquist bin's column is 0."""
    def mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)

    lo, hi = mel(LOW_FREQ), mel(0.5 * sample_rate)
    delta = (hi - lo) / (num_bins + 1)
    left = lo + np.arange(num_bins)[:, None] * delta
    center, right = left + delta, left + 2 * delta
    m = mel(sample_rate / n_fft * np.arange(n_fft // 2))[None, :]
    banks = np.maximum(0.0, np.minimum((m - left) / (center - left), (right - m) / (right - center)))
    return np.pad(banks, ((0, 0), (0, 1)))


def kaldi_fbank(audio: torch.Tensor, window: torch.Tensor, banks: torch.Tensor, shift: int,
                n_fft: int) -> torch.Tensor:
    """[B, T] audio -> [B, frames, mel bins] log mel energies (float32; ``window``
    [size] and ``banks`` [bins, n_fft // 2 + 1] float32)."""
    x = audio.float()
    x = x - x.mean(dim=-1, keepdim=True)
    frames = x.unfold(-1, window.shape[0], shift)  # snip_edges
    frames = frames - frames.mean(dim=-1, keepdim=True)
    previous = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = (frames - PREEMPHASIS * previous) * window
    power = torch.fft.rfft(frames, n=n_fft).abs().pow(2.0)
    return torch.clamp_min(power @ banks.T, torch.finfo(torch.float32).eps).log()


def _trunc_normal(t: torch.Tensor, generator=None, std: float = 0.02) -> torch.Tensor:
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


def _linear(n_in: int, n_out: int, generator=None) -> Linear:
    """Linear with DeiT's init (truncated normal, std 0.02; zero bias)."""
    lin = Linear(n_in, n_out)
    _trunc_normal(lin.weight, generator)
    nn.init.zeros_(lin.bias)
    return lin


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, generator=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = _linear(dim, 3 * dim, generator)
        self.proj = _linear(dim, dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads).permute(2, 0, 3, 1, 4).unbind(0)
        out = F.scaled_dot_product_attention(q, k, v)  # [B, heads, N, head dim]
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, generator=None):
        super().__init__()
        self.fc1 = _linear(dim, hidden, generator)
        self.fc2 = _linear(hidden, dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int, generator=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, generator)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, mlp_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, patch_size: int, stride: Tuple[int, int], generator=None):
        super().__init__()
        self.proj = conv2d(1, embed_dim, patch_size, stride=stride, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, 1, F, T] -> [B, patches, D]
        return self.proj(x).flatten(2).transpose(1, 2)


class VisionTransformer(nn.Module):
    """AST's ``v``: the DeiT trunk with two class tokens."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int, mlp_dim: int, patch_size: int,
                 stride: Tuple[int, int], tokens: int, generator=None):
        super().__init__()
        self.patch_embed = PatchEmbed(embed_dim, patch_size, stride, generator)
        self.cls_token = nn.Parameter(_trunc_normal(torch.empty(1, 1, embed_dim), generator))
        self.dist_token = nn.Parameter(_trunc_normal(torch.empty(1, 1, embed_dim), generator))
        self.pos_embed = nn.Parameter(_trunc_normal(torch.empty(1, tokens, embed_dim), generator))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_dim, generator) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, image: torch.Tensor) -> torch.Tensor:  # [B, 1, F, T] -> [B, tokens, D], float32
        x = self.patch_embed(image).float()
        b = x.shape[0]
        x = torch.cat([self.cls_token.float().expand(b, -1, -1), self.dist_token.float().expand(b, -1, -1), x], 1)
        x = x + self.pos_embed.float()
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)


class AST(nn.Module):
    """[B, 1, T] audio -> [B, dim]; the keyword arguments are ``audio_tower.ast``'s."""

    def __init__(self, dim: int, sample_rate: float, input_fdim: int = 128, input_tdim: int = 400,
                 frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0, patch_size: int = 16,
                 fstride: int = 10, tstride: int = 10, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072, norm_mean: float = -4.2677393,
                 norm_std: float = 4.5689974, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_tdim = input_tdim
        self.norm_mean, self.norm_std = norm_mean, norm_std
        size, self.shift, self.n_fft = frame_geometry(sample_rate, frame_length_ms, frame_shift_ms)
        grid = ((input_fdim - patch_size) // fstride + 1) * ((input_tdim - patch_size) // tstride + 1)
        self.tokens_per_voice = 2 + grid
        self.v = VisionTransformer(embed_dim, depth, num_heads, mlp_dim, patch_size, (fstride, tstride),
                                   self.tokens_per_voice, generator)
        self.mlp_head = nn.Sequential(nn.LayerNorm(embed_dim), _linear(embed_dim, dim, generator))
        # made here, not at the first forward (torch.tensor: on the device being built on)
        hann = 0.5 - 0.5 * np.cos(2 * math.pi * np.arange(size) / (size - 1))
        self.register_buffer("window", torch.tensor(hann, dtype=torch.float32), persistent=False)
        self.register_buffer("mel_banks", torch.tensor(kaldi_mel_banks(input_fdim, self.n_fft, sample_rate),
                                                       dtype=torch.float32), persistent=False)

    @property
    def sdpa_backends(self) -> Tuple[SDPBackend, ...]:
        """The attention backends allowed on the weights' device."""
        return FUSED_BACKENDS if self.v.pos_embed.device.type == "cuda" else (SDPBackend.MATH,)

    def fbank(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, 1, T] audio -> [B, input_tdim, input_fdim] normalised log mel energies (float32)."""
        with torch.autocast(device_type=audio.device.type, enabled=False):
            x = kaldi_fbank(audio[:, 0], self.window, self.mel_banks, self.shift, self.n_fft)
            pad = self.input_tdim - x.shape[1]
            x = F.pad(x, (0, 0, 0, pad)) if pad > 0 else x[:, :self.input_tdim]
            return (x - self.norm_mean) / (2.0 * self.norm_std)

    def encode(self, features: torch.Tensor) -> torch.Tensor:
        """[B, input_tdim, input_fdim] -> [B, dim]."""
        with sdpa_kernel(list(self.sdpa_backends)):
            x = self.v(features.transpose(1, 2).unsqueeze(1))
        return self.mlp_head((x[:, 0] + x[:, 1]) / 2)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        if audio.dim() != 3 or audio.shape[1] != 1:
            raise ValueError(f"audio must be [B, 1, T], got {tuple(audio.shape)}")
        with span("tower/frontend"):
            features = self.fbank(audio)
        with span("tower/encoder"):
            return self.encode(features)
