"""The HTS-AT audio tower, its VICReg model and its pretraining steps, in plain
float32 torch.

Chen et al., "HTS-AT: A Hierarchical Token-Semantic Audio Transformer"
(arXiv:2202.00874, github.com/RetroCirce/HTS-Audio-Transformer), as LAION-CLAP
ships it (arXiv:2211.06687, github.com/LAION-AI/CLAP
``src/laion_clap/clap_module/htsat.py`` ``create_htsat_model(model_name=
'base')``; front end ``model_configs/HTSAT-base.json``). The layer equations,
as published:

- Front end: torchlibrosa's ``Spectrogram`` and ``LogmelFilterBank``: the
  waveform reflect-padded by n_fft / 2 on each side; frames of n_fft samples
  every ``HOP_SIZE``; a periodic Hann window 0.5 - 0.5 cos(2 pi n / n_fft);
  |rfft|^2; librosa's ``filters.mel`` on the slaney scale (linear below 1 kHz
  at 200/3 Hz a mel, logarithmic above with a step of ln(6.4) / 27) with
  slaney norm (each triangle scaled by 2 / its width in Hz) from ``FMIN`` to
  ``FMAX``; 10 log10(max(., 1e-10)). Then ``bn0``, a BatchNorm over the mel
  bins; a bicubic stretch of the time axis to spec_size x freq_ratio frames
  (cubic convolution with a = -0.75, ``align_corners``: output frame j
  samples input position j (T_in - 1) / (T_out - 1), edges clamped), written
  as a matrix; ``reshape_wav2img``: [B, 1, T, F] -> [B, 1, F, T] -> [B, 1, F,
  r, T / r] -> [B, 1, r, F, T / r] -> [B, 1, r F, T / r].
- Patches: Conv2d(1, D, 4, stride 4), flattened row-major, LayerNorm; no
  position embedding.
- Each stage i (width D 2^i, grid R = grid_0 / 2^i, window W = min(window,
  R)) holds ``depths[i]`` Swin blocks; block j shifts by s = W / 2 when j is
  odd and R > W. A block: h = LN1(x) as a [B, R, R, C] image, rolled by -s
  on both axes (h'[y, x] = h[(y + s) mod R, (x + s) mod R]); cut into W x W
  windows [B nW, W^2, C]; per window and head softmax(q k^T / sqrt(head dim)
  + table[idx] + mask) v with qkv one Linear(C, 3C) with a bias, idx[a, b] =
  (y_a - y_b + W - 1)(2W - 1) + (x_a - x_b + W - 1), and mask -100 where a
  and b lie in different regions of the rolled image (rows and columns
  split at R - W and R - s, Swin's ``img_mask``), 0 elsewhere and on blocks
  that do not shift; proj; windows put back, rolled by +s; x = x + h; then
  x = x + fc2(GELU(fc1(LN2(x)))), hidden 4C. LayerNorm eps 1e-5 (biased
  variance). After stages 1-3: cat(x[0::2, 0::2], x[1::2, 0::2], x[0::2,
  1::2], x[1::2, 1::2]) -> LayerNorm(4C) -> Linear(4C, 2C, no bias).
- Output: LayerNorm, the mean over the tokens, then ``head`` Linear(D 2^3,
  dim) in place of the token-semantic head.

The parameter names are the measured package's. The Linear layers, the patch
convolution and the products inside attention go through ``towers.py``'s
``Linear``, ``Conv`` and ``matmul``, and the attention's additive bias plus
mask and its output through ``towers.py``'s rounding, so the float8 control
rounds them where the program computes in bf16 and ``counts/model_flops.py``
sees the layers; the front end, ``bn0``, LayerNorm, softmax and the residual
stream stay float32 there as in the program.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn

from . import synth as S
from . import towers as T
from .ast import LayerNorm, Mlp
from .lars import lars_step, learning_rate
from .train import _dropout_generator, _load, _rounded

AMIN = 1e-10
MASK_VALUE = -100.0
CUBIC_A = -0.75
# HTSAT-base.json's window and FFT size, hop and mel band edges (Hz); the patch
# size and stride of create_htsat_model('base')
WINDOW_SIZE = 1024
HOP_SIZE = 480
FMIN = 50.0
FMAX = 14000.0
PATCH_SIZE = 4


# -- front end ----------------------------------------------------------------------------


def _hz_to_mel(f: torch.Tensor) -> torch.Tensor:
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = math.log(6.4) / 27.0
    return torch.where(f >= min_log_hz, min_log_hz / f_sp + torch.log(f / min_log_hz) / logstep, f / f_sp)


def _mel_to_hz(m: torch.Tensor) -> torch.Tensor:
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, math.log(6.4) / 27.0
    return torch.where(m >= min_log_mel, min_log_hz * torch.exp(logstep * (m - min_log_mel)), f_sp * m)


def slaney_mel(rate: float, n_fft: int, n_mels: int, fmin: float, fmax: float, device=None) -> torch.Tensor:
    """[n_fft // 2 + 1, n_mels] float32 weights, built in float64."""
    f64 = dict(dtype=torch.float64)
    edges = _mel_to_hz(torch.linspace(float(_hz_to_mel(torch.tensor(fmin, **f64))),
                                      float(_hz_to_mel(torch.tensor(fmax, **f64))), n_mels + 2, **f64))
    freqs = torch.arange(n_fft // 2 + 1, **f64) * rate / n_fft
    lo, mid, hi = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    tri = torch.clamp(torch.minimum((freqs - lo) / (mid - lo), (hi - freqs) / (hi - mid)), min=0.0)
    return (tri * (2.0 / (hi - lo))).T.float().to(device)


def logmel(audio: torch.Tensor, rate: float, n_fft: int, hop: int, n_mels: int, fmin: float,
           fmax: float) -> torch.Tensor:
    """[B, T] audio -> [B, frames, n_mels] log mel power in dB, float32."""
    device = audio.device
    x = audio.float()
    pad = n_fft // 2
    x = torch.cat([x[:, 1:pad + 1].flip(1), x, x[:, -pad - 1:-1].flip(1)], dim=1)
    n_frames = 1 + audio.shape[1] // hop
    index = torch.arange(n_frames, device=device)[:, None] * hop + torch.arange(n_fft, device=device)[None, :]
    n = torch.arange(n_fft, dtype=torch.float64, device=device)
    window = (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / n_fft)).float()
    spectrum = torch.fft.rfft(x[:, index] * window)
    power = spectrum.real ** 2 + spectrum.imag ** 2
    mel = power @ slaney_mel(rate, n_fft, n_mels, fmin, fmax, device)
    return 10.0 * torch.log10(torch.maximum(mel, torch.tensor(AMIN, device=device)))


def bicubic_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """[n_out, n_in] float32: bicubic interpolation with aligned corners, built in
    float64 from source positions rounded to float32, as torch's upsampling
    computes them (a float32 scale times the output index)."""
    scale = torch.tensor((n_in - 1) / (n_out - 1), dtype=torch.float32)
    src = (torch.arange(n_out, dtype=torch.float32) * scale).double()
    base = torch.floor(src)
    t = src - base

    def near(d):  # |d| <= 1
        return ((CUBIC_A + 2) * d - (CUBIC_A + 3)) * d * d + 1

    def far(d):  # 1 < |d| < 2
        return ((CUBIC_A * d - 5 * CUBIC_A) * d + 8 * CUBIC_A) * d - 4 * CUBIC_A

    out = torch.zeros(n_out, n_in, dtype=torch.float64)
    rows = torch.arange(n_out)
    for offset, weight in ((-1, far(t + 1)), (0, near(t)), (1, near(1 - t)), (2, far(2 - t))):
        cols = torch.clamp(base.long() + offset, 0, n_in - 1)
        out.index_put_((rows, cols), weight, accumulate=True)
    return out.float().to(device)


# -- Swin blocks ------------------------------------------------------------------------------


def roll(x: torch.Tensor, s: int) -> torch.Tensor:
    """[B, R, R, C] rolled by s on both grid axes: out[y, x] = in[(y - s) mod R, (x - s) mod R]."""
    r = x.shape[1]
    index = (torch.arange(r, device=x.device) - s) % r
    return x[:, index][:, :, index]


def partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, R, R, C] -> [B nW, W^2, C], windows row-major."""
    b, r, _, c = x.shape
    return x.view(b, r // w, w, r // w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def reverse(windows: torch.Tensor, w: int, r: int) -> torch.Tensor:
    """``partition``'s inverse."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((r // w) ** 2)
    return windows.view(b, r // w, r // w, w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(b, r, r, c)


def relative_index(w: int) -> torch.Tensor:
    """[W^2, W^2] int64: (y_a - y_b + W - 1)(2W - 1) + (x_a - x_b + W - 1)."""
    pos = torch.arange(w * w)
    y, x = pos // w, pos % w
    return (y[:, None] - y[None, :] + w - 1) * (2 * w - 1) + (x[:, None] - x[None, :] + w - 1)


def region_mask(r: int, w: int, s: int) -> torch.Tensor:
    """[nW, W^2, W^2] float32: Swin's ``attn_mask`` for a grid rolled by -s."""
    img = torch.zeros(1, r, r, 1)
    cuts = (slice(0, r - w), slice(r - w, r - s), slice(r - s, r))
    count = 0
    for hs in cuts:
        for ws in cuts:
            img[:, hs, ws, :] = count
            count += 1
    labels = partition(img, w)[..., 0]  # [nW, W^2]
    diff = labels[:, None, :] - labels[:, :, None]
    return torch.where(diff != 0, MASK_VALUE, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, w: int, heads: int):
        super().__init__()
        self.w, self.heads = w, heads
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * w - 1) ** 2, heads))
        self.qkv = T.Linear(dim, 3 * dim)
        self.proj = T.Linear(dim, dim)

    def forward(self, x, mask):  # [B nW, N, C]; mask [nW, N, N] or None
        bw, n, c = x.shape
        hd = c // self.heads
        qkv = self.qkv(x).reshape(bw, n, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [B nW, heads, N, head dim]
        scores = T.matmul(q, k.transpose(-2, -1)) / math.sqrt(hd)
        index = relative_index(self.w).to(x.device).reshape(-1)
        bias = self.relative_position_bias_table[index].reshape(n, n, self.heads).permute(2, 0, 1)
        if mask is None:
            scores = scores + T._round(bias)[None]
        else:
            nw = mask.shape[0]
            add = T._round(bias[None] + mask[:, None])  # [nW, heads, N, N]
            scores = (scores.view(bw // nw, nw, self.heads, n, n) + add[None]).view(bw, self.heads, n, n)
        out = T._round(T.matmul(torch.softmax(scores, dim=-1), v))
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, r: int, w: int, heads: int, s: int):
        super().__init__()
        self.r, self.w, self.s = r, w, s
        self.norm1 = LayerNorm(dim, 1e-5)
        self.attn = WindowAttention(dim, w, heads)
        self.norm2 = LayerNorm(dim, 1e-5)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x):  # [B, R^2, C]
        b, l, c = x.shape
        h = self.norm1(x).view(b, self.r, self.r, c)
        mask = None
        if self.s:
            h = roll(h, -self.s)
            mask = region_mask(self.r, self.w, self.s).to(x.device)
        h = reverse(self.attn(partition(h, self.w), mask), self.w, self.r)
        if self.s:
            h = roll(h, self.s)
        x = x + h.reshape(b, l, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, r: int):
        super().__init__()
        self.r = r
        self.norm = LayerNorm(4 * dim, 1e-5)
        self.reduction = T.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, _, c = x.shape
        x = x.view(b, self.r, self.r, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * c)))


class Stage(nn.Module):
    def __init__(self, dim: int, r: int, depth: int, heads: int, window: int, merge: bool):
        super().__init__()
        w = min(window, r)
        self.blocks = nn.ModuleList(SwinBlock(dim, r, w, heads, w // 2 if (j % 2 and r > w) else 0)
                                    for j in range(depth))
        self.downsample = PatchMerging(dim, r) if merge else None


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = T.Conv(1, dim, PATCH_SIZE, stride=PATCH_SIZE)
        self.norm = LayerNorm(dim, 1e-5)


class HTSAT(nn.Module):
    """[B, 1, T] audio -> [B, dim]; the keyword arguments are ``audio_tower.htsat``'s."""

    def __init__(self, dim: int, rate: float, mel_bins: int, spec_size: int, embed_dim: int, depths,
                 num_heads, window: int):
        super().__init__()
        self.rate, self.mel_bins, self.spec_size = rate, mel_bins, spec_size
        self.ratio = spec_size // mel_bins
        grid = spec_size // PATCH_SIZE
        self.bn0 = T.BatchNorm(mel_bins, 1e-5, 0.9, rounds=False)
        self.patch_embed = PatchEmbed(embed_dim)
        last = len(depths) - 1
        self.layers = nn.ModuleList(Stage(embed_dim * 2 ** i, grid // 2 ** i, depths[i], num_heads[i], window,
                                          i < last) for i in range(len(depths)))
        self.norm = LayerNorm(embed_dim * 2 ** last, 1e-5)
        self.head = T.Linear(embed_dim * 2 ** last, dim)

    def image(self, audio):
        """[B, 1, T] -> [B, 1, spec_size, spec_size]: the image the patches are cut from."""
        x = logmel(audio[:, 0], self.rate, WINDOW_SIZE, HOP_SIZE, self.mel_bins, FMIN, FMAX)
        x = self.bn0(x.transpose(1, 2)).transpose(1, 2)  # [B, T, F]
        target = self.spec_size * self.ratio
        if x.shape[1] < target:
            x = bicubic_matrix(x.shape[1], target, x.device) @ x
        b, t, f = x.shape
        x = x.transpose(1, 2).reshape(b, 1, f, self.ratio, t // self.ratio)
        return x.permute(0, 1, 3, 2, 4).reshape(b, 1, self.ratio * f, t // self.ratio)

    def encode(self, image):
        """[B, 1, spec_size, spec_size] -> [B, dim]."""
        pe = self.patch_embed
        x = pe.norm(pe.proj(image).flatten(2).transpose(1, 2))
        for stage in self.layers:
            for blk in stage.blocks:
                x = blk(x)
            if stage.downsample is not None:
                x = stage.downsample(x)
        return self.head(self.norm(x).mean(dim=1))

    def forward(self, audio):
        return self.encode(self.image(audio))


def htsat_kwargs(cfg) -> Dict:
    return dict(cfg["audio_tower"]["htsat"])


class VICReg(nn.Module):
    """The HTS-AT audio tower, towers.py's parameter tower and projector."""

    def __init__(self, cfg):
        super().__init__()
        dims = tuple(int(v) for v in (f"{cfg['dim']}-" + cfg["vicreg"]["mlp"] % cfg["embeddim"]).split("-"))
        self.backbone_audio = HTSAT(cfg["dim"], cfg["torchsynth"]["rate"], **htsat_kwargs(cfg))
        self.backbone_param = T.ParamEmbed(cfg["nparams"], cfg["dim"], cfg["param_embed"]["dropout"])
        self.projector = T.Projector(dims)

    def forward(self, audio, params):
        return self.projector(self.backbone_audio(audio)), self.projector(self.backbone_param(params))


def pretrain(cfg, weights: Dict[str, torch.Tensor], batch_nums: List[int], device) -> Dict:
    """The VICReg steps for ``batch_nums`` from ``weights``, as ``train.pretrain``
    takes them, with the HTS-AT audio tower."""
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
