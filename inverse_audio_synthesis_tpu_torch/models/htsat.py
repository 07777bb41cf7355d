"""Audio tower: audio -> log-mel -> HTS-AT (Swin Transformer over the spectrogram image) -> [B, dim].

HTS-AT, the Hierarchical Token-Semantic Audio Transformer of Chen et al.
(arXiv:2202.00874, github.com/RetroCirce/HTS-Audio-Transformer), as LAION-CLAP
ships it as its audio encoder (arXiv:2211.06687, github.com/LAION-AI/CLAP,
``src/laion_clap/clap_module/htsat.py`` ``create_htsat_model`` with
``model_name='base'``; front end from ``model_configs/HTSAT-base.json``).

- Front end (``frontend``, float32, outside autocast): ``ops/stft.py``'s
  power spectrogram (periodic Hann of ``WINDOW_SIZE``, hop ``HOP_SIZE``,
  ``center=True`` with reflect padding, |X|^2) and its mel filterbank on the
  slaney scale with slaney norm (librosa's ``filters.mel``, as torchlibrosa's
  ``LogmelFilterBank`` builds it) from ``FMIN`` to ``FMAX`` (HTSAT-base.json's
  values, fixed here);
  ``10 log10(max(x, 1e-10))`` (ref 1, no ``top_db``); ``bn0``, a BatchNorm over
  the mel bins; a bicubic stretch (``align_corners=True``) of the time axis to
  ``spec_size x freq_ratio`` frames (``freq_ratio = spec_size // mel_bins``);
  HTS-AT's ``reshape_wav2img``: [B, 1, T, F] -> [B, 1, F, r, T/r] -> [B, 1,
  spec_size, spec_size]. 4 s at 44.1 kHz: 368 frames stretched to 1,024, a
  256 x 256 image.
- Encoder (``encode``): ``patch_embed``, Conv2d(1, embed_dim, PATCH_SIZE,
  stride PATCH_SIZE) and LayerNorm, no absolute position embedding; four
  ``layers`` of Swin blocks, stage i at width ``embed_dim x 2^i`` on a grid
  of ``spec_size / PATCH_SIZE / 2^i`` (64, 32, 16, 8), ``depths`` blocks and
  ``num_heads`` heads of 32; after stages 1-3 ``PatchMerging``
  (cat(x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2]) ->
  LayerNorm(4C) -> Linear(4C, 2C, no bias)); then ``norm``, LayerNorm(1024),
  and the mean over the tokens (HTS-AT's ``latent_output``, CLAP's audio
  ``embedding``).
- A Swin block: ``h = roll(LN1(x), (-s, -s))``; W x W windows; in each,
  ``softmax(q k^T / sqrt(32) + T[idx] + M) v`` with ``qkv`` one Linear(C, 3C)
  with bias, ``T`` the learned [(2W - 1)^2, heads] ``relative_position_bias_table``,
  ``idx[a, b] = (dy + W - 1)(2W - 1) + (dx + W - 1)`` and ``M`` -100 between
  tokens of different regions of the shifted grid (Swin's mask); ``proj``;
  the windows merged and rolled back by ``+s``; ``x += h``; then
  ``x += fc2(GELU(fc1(LN2(x))))`` with hidden width 4C. The window is
  ``min(window, grid)``; the shift ``s = W / 2`` on every second block where
  the grid is wider than the window, else 0: 8 of the 18 blocks shift, and
  stage 4's one window is full attention. LayerNorm eps 1e-5.
- ``head``: Linear(1024, dim) in place of the token-semantic CNN head over
  527 classes.

Departures: no SpecAugment, mixup or fusion (VICReg's recipe has none); no
drop-path or dropout; ``bn0`` keeps flax's running statistics, as every
BatchNorm of the port does (the biased batch variance; the batch's own
statistics in train mode, as torch's); the patch convolution is initialised
as the port's other convolutions (lecun normal; HTS-AT leaves torch's
default), Linear layers and the bias tables with HTS-AT's truncated normal
of std 0.02.

The residual stream is float32; under bf16 autocast the Linear layers, the
patch convolution and the attention run in bf16 and LayerNorm in float32.
Attention is ``F.scaled_dot_product_attention`` with q, k and v viewed as
[B, windows x heads, W^2, 32] and bias plus mask as one ``attn_mask`` [1,
windows x heads, W^2, W^2] broadcast over the batch, in q's dtype; the mask
requires a gradient (the bias table learns). On CUDA it runs under the AST's
guard (``models/ast.py:FUSED_BACKENDS``: a call no fused backend takes
raises); of those only the memory-efficient backend takes a mask that
requires a gradient. On the CPU it runs the math path. Under a profiler the
front end is the span ``tower/frontend`` and the rest ``tower/encoder``, with
``tower/stage1`` to ``tower/stage4`` inside it. Counters:
``tokens_per_stage``, ``windows_per_voice`` (a block of each stage),
``shifted_blocks`` and ``sdpa_backends`` (of the device the weights are on).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from inverse_audio_synthesis_tpu_torch.models.ast import FUSED_BACKENDS, Mlp, _linear, _trunc_normal
from inverse_audio_synthesis_tpu_torch.models.layers import BatchNorm, Linear, conv2d
from inverse_audio_synthesis_tpu_torch.ops.stft import mel_filterbank, spectrogram
from inverse_audio_synthesis_tpu_torch.utils.profiling import span

AMIN = 1e-10
MASK_VALUE = -100.0
# LAION-CLAP model_configs/HTSAT-base.json: FFT and window size, hop, mel band
# edges in Hz; clap_module/htsat.py create_htsat_model('base'): 4 x 4 patches
# every 4 pixels (the published patch_stride)
WINDOW_SIZE = 1024
HOP_SIZE = 480
FMIN = 50.0
FMAX = 14000.0
PATCH_SIZE = 4


def relative_position_index(window: int) -> torch.Tensor:
    """[W^2, W^2] int64: ``(dy + W - 1)(2W - 1) + (dx + W - 1)`` of tokens a and b
    of a window, row-major, with (dy, dx) = a's position less b's."""
    y, x = torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij")
    y, x = y.flatten(), x.flatten()
    dy, dx = y[:, None] - y[None, :], x[:, None] - x[None, :]
    return (dy + window - 1) * (2 * window - 1) + (dx + window - 1)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, R, R, C] -> [B, (R / W)^2, W^2, C], windows row-major."""
    b, r, _, c = x.shape
    n = r // window
    return x.view(b, n, window, n, window, c).transpose(2, 3).reshape(b, n * n, window * window, c)


def window_merge(windows: torch.Tensor, window: int, grid: int) -> torch.Tensor:
    """``window_partition``'s inverse: [B, (R / W)^2, W^2, C] -> [B, R, R, C]."""
    b, _, _, c = windows.shape
    n = grid // window
    return windows.view(b, n, n, window, window, c).transpose(2, 3).reshape(b, grid, grid, c)


def shift_mask(grid: int, window: int, shift: int) -> torch.Tensor:
    """[(R / W)^2, W^2, W^2] float32: ``MASK_VALUE`` between tokens of a window of
    the grid rolled by -shift that come from different regions, 0 elsewhere."""
    bands = torch.zeros(grid, dtype=torch.long)
    bands[grid - window:grid - shift] = 1
    bands[grid - shift:] = 2
    regions = (bands[:, None] * 3 + bands[None, :]).float()[None, :, :, None]
    labels = window_partition(regions, window)[0, :, :, 0]  # [windows, W^2]
    same = labels[:, :, None] == labels[:, None, :]
    return torch.where(same, 0.0, MASK_VALUE)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int, generator=None):
        super().__init__()
        self.window, self.num_heads = window, num_heads
        self.relative_position_bias_table = nn.Parameter(
            _trunc_normal(torch.empty((2 * window - 1) ** 2, num_heads), generator))
        self.register_buffer("relative_position_index", relative_position_index(window), persistent=False)
        self.qkv = _linear(dim, 3 * dim, generator)
        self.proj = _linear(dim, dim, generator)

    def bias(self) -> torch.Tensor:
        """[heads, W^2, W^2]: the table gathered by ``relative_position_index``."""
        n = self.window * self.window
        return self.relative_position_bias_table[self.relative_position_index.view(-1)].view(n, n, -1).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """[B, windows, N, C] -> the same; ``mask`` [windows, N, N] or None."""
        b, nw, n, c = x.shape
        h = self.num_heads
        q, k, v = (self.qkv(x).view(b, nw, n, 3, h, c // h).permute(3, 0, 1, 4, 2, 5)
                   .reshape(3, b, nw * h, n, c // h).unbind(0))
        bias = self.bias()[None]
        bias = bias + mask[:, None] if mask is not None else bias.expand(nw, h, n, n)
        # the kernels read the mask's rows with stride 1: the gathered table is head-last
        attn_mask = bias.reshape(1, nw * h, n, n).to(q.dtype, memory_format=torch.contiguous_format)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)
        return self.proj(out.view(b, nw, h, n, c // h).transpose(2, 3).reshape(b, nw, n, c))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, grid: int, window: int, num_heads: int, shift: int, generator=None):
        super().__init__()
        self.grid, self.window, self.shift = grid, window, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window, num_heads, generator)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim, generator)
        self.register_buffer("attn_mask", shift_mask(grid, window, shift) if shift else None, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, R^2, C] float32
        b, l, c = x.shape
        h = self.norm1(x).view(b, self.grid, self.grid, c)
        if self.shift:
            h = torch.roll(h, (-self.shift, -self.shift), (1, 2))
        h = window_merge(self.attn(window_partition(h, self.window), self.attn_mask), self.window, self.grid)
        if self.shift:
            h = torch.roll(h, (self.shift, self.shift), (1, 2))
        x = x + h.reshape(b, l, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, grid: int, generator=None):
        super().__init__()
        self.grid = grid
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)
        _trunc_normal(self.reduction.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, R^2, C] -> [B, R^2 / 4, 2C]
        b, _, c = x.shape
        x = x.view(b, self.grid, self.grid, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x.view(b, -1, 4 * c)))


class Stage(nn.Module):
    """HTS-AT's ``BasicLayer``: Swin blocks, then patch merging but after the last stage."""

    def __init__(self, dim: int, grid: int, depth: int, num_heads: int, window: int, merge: bool, generator=None):
        super().__init__()
        window = min(window, grid)
        shift = window // 2 if grid > window else 0
        self.blocks = nn.ModuleList(SwinBlock(dim, grid, window, num_heads, shift if j % 2 else 0, generator)
                                    for j in range(depth))
        self.downsample = PatchMerging(dim, grid, generator) if merge else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x) if self.downsample is not None else x


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, generator=None):
        super().__init__()
        self.proj = conv2d(1, embed_dim, PATCH_SIZE, stride=PATCH_SIZE, generator=generator)
        self.norm = nn.LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, 1, S, S] -> [B, grid^2, D], float32
        return self.norm(self.proj(x).flatten(2).transpose(1, 2).float())


class HTSAT(nn.Module):
    """[B, 1, T] audio -> [B, dim]; the keyword arguments are ``audio_tower.htsat``'s."""

    def __init__(self, dim: int, sample_rate: float, mel_bins: int = 64, spec_size: int = 256,
                 embed_dim: int = 128, depths: Sequence[int] = (2, 2, 12, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec_size = spec_size
        self.freq_ratio = spec_size // mel_bins
        grid = spec_size // PATCH_SIZE
        grids = [grid // 2 ** i for i in range(len(depths))]
        self.tokens_per_stage = tuple(g * g for g in grids)
        self.windows_per_voice = tuple((g // min(window, g)) ** 2 for g in grids)
        self.bn0 = BatchNorm(mel_bins, eps=1e-5, momentum=0.9)
        self.patch_embed = PatchEmbed(embed_dim, generator)
        self.layers = nn.ModuleList(
            Stage(embed_dim * 2 ** i, g, depth, heads, window, i < len(depths) - 1, generator)
            for i, (g, depth, heads) in enumerate(zip(grids, depths, num_heads)))
        self.num_features = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(self.num_features)
        self.head = _linear(self.num_features, dim, generator)
        self.shifted_blocks = sum(1 for s in self.layers for blk in s.blocks if blk.shift)
        self.total_blocks = sum(len(s.blocks) for s in self.layers)
        # made here, not at the first forward (torch.tensor: on the device being built on)
        fb = mel_filterbank(WINDOW_SIZE // 2 + 1, mel_bins, sample_rate, FMIN, FMAX, "slaney", "slaney")
        self.register_buffer("mel_fb", torch.tensor(fb), persistent=False)

    @property
    def sdpa_backends(self) -> Tuple[SDPBackend, ...]:
        """The attention backends allowed on the weights' device."""
        return FUSED_BACKENDS if self.head.weight.device.type == "cuda" else (SDPBackend.MATH,)

    def logmel(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, 1, T] audio -> [B, frames, mel bins] log mel power in dB (float32)."""
        power = spectrogram(audio[:, 0].float(), power=2.0, n_fft=WINDOW_SIZE, hop_length=HOP_SIZE,
                            win_length=WINDOW_SIZE, center=True, pad_mode="reflect")
        mel = power.transpose(1, 2) @ self.mel_fb
        return 10.0 * torch.log10(torch.clamp_min(mel, AMIN))

    def frontend(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, 1, T] audio -> [B, 1, spec_size, spec_size]: the image the encoder takes (float32)."""
        with torch.autocast(device_type=audio.device.type, enabled=False):
            x = self.bn0(self.logmel(audio).transpose(1, 2)).transpose(1, 2)[:, None]  # [B, 1, T, F]
            target = self.spec_size * self.freq_ratio
            if x.shape[2] < target:
                x = F.interpolate(x, (target, x.shape[3]), mode="bicubic", align_corners=True)
            b, _, t, f = x.shape
            x = x.permute(0, 1, 3, 2).reshape(b, 1, f, self.freq_ratio, t // self.freq_ratio)
            return x.permute(0, 1, 3, 2, 4).reshape(b, 1, f * self.freq_ratio, t // self.freq_ratio)

    def encode(self, image: torch.Tensor) -> torch.Tensor:
        """[B, 1, spec_size, spec_size] -> [B, dim]."""
        with sdpa_kernel(list(self.sdpa_backends)):
            x = self.patch_embed(image)
            for i, stage in enumerate(self.layers):
                with span(f"tower/stage{i + 1}"):
                    x = stage(x)
        return self.head(self.norm(x).mean(1))

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        if audio.dim() != 3 or audio.shape[1] != 1:
            raise ValueError(f"audio must be [B, 1, T], got {tuple(audio.shape)}")
        with span("tower/frontend"):
            image = self.frontend(audio)
        with span("tower/encoder"):
            return self.encode(image)
