"""The two towers, the shared projector, the downstream head and the VICReg loss,
in plain float32 torch.

The layer equations of the measured model, written out once more for the
benchmark: a PQMF analysis filterbank (Kaiser-window prototype, 3 bands, 62
taps) reshapes 4 s of audio into a 3 x 240 x 245 pseudo-image; ImageNet
normalisation; the MobileNetV3-Small feature trunk (BatchNorm eps 1e-3,
hardswish / hardsigmoid, squeeze-excitation); stacked 2 x 2 valid convolutions
down to 1 x 1 -> [B, dim]. The parameter tower and the head are MLPs of
Linear -> BatchNorm -> Dropout -> ReLU blocks; the projector is Linear ->
BatchNorm -> ReLU blocks and a bias-free last Linear. BatchNorm follows flax:
statistics E[x^2] - E[x]^2 in float32, biased variance, running averages with
the old value weighted by ``momentum``. The parameter and buffer names are the
measured package's, so one state dict loads into both.

``PRECISION`` selects the rounding: ``"fp32"`` (the reference; TF32 must be
off, ``reference.strict``) or ``"fp8"``, the benchmark's control: the float8
recipe of mixed-precision training (e4m3 in the forward pass, e5m2 for the
gradients, each tensor scaled by its largest magnitude) wherever the measured
program's bf16 recipe holds a tensor in bf16: the operands and outputs of the
matrix products and convolutions, the output of the trunk's and the
projector's BatchNorms (the MLPs' BatchNorms emit float32), the trunk's
activations, squeeze-excitation and residual sums, the covariance operands,
and, in ``train.py``, the gradients of the matrices and kernels.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

PRECISION = "fp32"
_E4M3_MAX = 448.0


def set_precision(name: str) -> None:
    global PRECISION
    if name not in ("fp32", "fp8"):
        raise ValueError(f"precision must be fp32 or fp8, got {name!r}")
    PRECISION = name


_FORMATS = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


def _fp8(x: torch.Tensor, fmt: str) -> torch.Tensor:
    dtype, top = _FORMATS[fmt]
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Round(torch.autograd.Function):
    """e4m3 in the forward pass, the incoming gradient in e5m2 in the backward."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, "e4m3")

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, "e5m2")


def _round(x: torch.Tensor) -> torch.Tensor:
    """x as the current precision holds it."""
    return x if PRECISION == "fp32" else _Round.apply(x)


def rounded_gradient(g: torch.Tensor) -> torch.Tensor:
    """A gradient as the current precision stores it."""
    return g if PRECISION == "fp32" else _fp8(g, "e5m2")


def linear(x, weight, bias=None):
    return _round(F.linear(_round(x), _round(weight), bias))


def conv2d(x, weight, bias=None, stride=1, padding=0, groups=1):
    return _round(F.conv2d(_round(x), _round(weight), bias, stride, padding, 1, groups))


def matmul(a, b):
    return _round(a) @ _round(b)


class BatchNorm(nn.Module):
    def __init__(self, n: int, eps: float, momentum: float, rounds: bool = True):
        super().__init__()
        self.eps, self.momentum, self.rounds = eps, momentum, rounds
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        shape = [1, -1] + [1] * (x.dim() - 2)
        if self.training:
            dims = [0] + list(range(2, x.dim()))
            mean = x.mean(dims)
            var = torch.clamp_min((x * x).mean(dims) - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(mean.detach(), alpha=1 - self.momentum)
                self.running_var.mul_(self.momentum).add_(var.detach(), alpha=1 - self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return _round(y) if self.rounds else y


class Dropout(nn.Module):
    """Keep with probability 1 - rate, scale by 1/(1 - rate); the mask is
    ``torch.rand(shape, generator) < 1 - rate``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class Linear(nn.Module):
    def __init__(self, n_in: int, n_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.zeros(n_out)) if bias else None

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class Conv(nn.Module):
    def __init__(self, n_in, n_out, kernel, stride=1, padding=0, groups=1, bias=True):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.weight = nn.Parameter(torch.empty(n_out, n_in // groups, kh, kw))
        self.bias = nn.Parameter(torch.zeros(n_out)) if bias else None
        self.stride, self.padding, self.groups = stride, padding, groups

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding, self.groups)


# -- PQMF -------------------------------------------------------------------------------


def pqmf_analysis_filters(n_bands: int = 3, taps: int = 62, cutoff: float = 0.15, beta: float = 9.0):
    """[n_bands, 1, taps + 1] cosine-modulated Kaiser-window analysis filters
    (the modulation centred at (taps - 1) / 2, as the upstream design has it)."""
    from scipy import signal

    proto = signal.firwin(taps + 1, cutoff, window=("kaiser", beta))
    k = np.arange(n_bands, dtype=np.float64)[:, None]
    t = np.arange(taps + 1, dtype=np.float64)[None, :]
    mod = (2.0 * k + 1.0) * (np.pi / (2.0 * n_bands)) * (t - (taps - 1) / 2.0)
    h = 2.0 * proto * np.cos(mod + ((-1.0) ** k) * (np.pi / 4.0))
    return torch.from_numpy(h[:, None, :].astype(np.float32))


# -- MobileNetV3-Small -----------------------------------------------------------------

# (kernel, expansion, out, squeeze-excitation, hardswish, stride)
SMALL = ((3, 16, 16, True, False, 2), (3, 72, 24, False, False, 2), (3, 88, 24, False, False, 1),
         (5, 96, 40, True, True, 2), (5, 240, 40, True, True, 1), (5, 240, 40, True, True, 1),
         (5, 120, 48, True, True, 1), (5, 144, 48, True, True, 1), (5, 288, 96, True, True, 2),
         (5, 576, 96, True, True, 1), (5, 576, 96, True, True, 1))


def _divisible(v, d=8):
    n = max(d, int(v + d / 2) // d * d)
    return n + d if n < 0.9 * v else n


def hardsigmoid(x):
    return F.relu6(x + 3.0) / 6.0


def hardswish(x):
    return x * hardsigmoid(x)


class ConvBNAct(nn.Module):
    def __init__(self, n_in, n_out, kernel, stride=1, groups=1, act="hardswish"):
        super().__init__()
        self.conv = Conv(n_in, n_out, kernel, stride, (kernel - 1) // 2, groups, bias=False)
        self.bn = BatchNorm(n_out, 1e-3, 0.99)
        self.act = {"hardswish": hardswish, "relu": F.relu, None: None}[act]

    def forward(self, x):
        x = self.bn(self.conv(x))
        return _round(self.act(x)) if self.act else x


class SqueezeExcitation(nn.Module):
    def __init__(self, ch, sq):
        super().__init__()
        self.fc1 = Conv(ch, sq, 1)
        self.fc2 = Conv(sq, ch, 1)

    def forward(self, x):
        s = self.fc2(_round(F.relu(self.fc1(_round(x.mean(dim=(2, 3), keepdim=True))))))
        return _round(x * _round(hardsigmoid(s)))


class InvertedResidual(nn.Module):
    def __init__(self, n_in, k, exp, n_out, se, hs, stride):
        super().__init__()
        act = "hardswish" if hs else "relu"
        blocks = ([ConvBNAct(n_in, exp, 1, act=act)] if exp != n_in else [])
        blocks.append(ConvBNAct(exp, exp, k, stride, exp, act))
        if se:
            blocks.append(SqueezeExcitation(exp, _divisible(exp // 4)))
        blocks.append(ConvBNAct(exp, n_out, 1, act=None))
        for i, b in enumerate(blocks):
            self.add_module(f"block_{i}", b)
        self.n = len(blocks)
        self.residual = stride == 1 and n_in == n_out

    def forward(self, x):
        y = x
        for i in range(self.n):
            y = getattr(self, f"block_{i}")(y)
        return _round(y + x) if self.residual else y


class MobileNetV3Small(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = ConvBNAct(3, 16, 3, 2)
        n_in = 16
        for i, (k, exp, out, se, hs, s) in enumerate(SMALL):
            self.add_module(f"bneck_{i}", InvertedResidual(n_in, k, exp, out, se, hs, s))
            n_in = out
        self.head = ConvBNAct(n_in, 576, 1)

    def forward(self, x):
        x = self.stem(x)
        for i in range(len(SMALL)):
            x = getattr(self, f"bneck_{i}")(x)
        return self.head(x)


def _feature_map(h, w):
    def down(n, k):
        return (n + 2 * ((k - 1) // 2) - k) // 2 + 1

    h, w = down(h, 3), down(w, 3)
    for k, *_, s in SMALL:
        if s == 2:
            h, w = down(h, k), down(w, k)
    return h, w


class AudioEmbedding(nn.Module):
    def __init__(self, dim: int, image_size: Tuple[int, int]):
        super().__init__()
        self.dim, self.image_size = dim, tuple(image_size)
        self.vision_model = MobileNetV3Small()
        h, w = _feature_map(*self.image_size)
        self.conv_names, n_in, i = [], 576, max(h, w) - 1
        while h > 1 or w > 1:
            kh, kw = (min(2, h) if h > 1 else 1), (min(2, w) if w > 1 else 1)
            self.add_module(f"conv{i}", Conv(n_in, dim, (kh, kw)))
            self.conv_names.append(f"conv{i}")
            n_in, h, w, i = dim, h - kh + 1, w - kw + 1, i - 1
        if n_in != dim:
            self.add_module("conv1", Conv(n_in, dim, 1))
            self.conv_names.append("conv1")
        self.register_buffer("pqmf_h", pqmf_analysis_filters(), persistent=False)
        self.register_buffer("pixel_mean", torch.tensor((0.485, 0.456, 0.406)).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("pixel_std", torch.tensor((0.229, 0.224, 0.225)).reshape(1, 3, 1, 1), persistent=False)

    def forward(self, audio):  # [B, 1, T] -> [B, dim]
        z = F.conv1d(audio.float(), self.pqmf_h, stride=3, padding=31)
        x = (z.reshape(-1, 3, *self.image_size) - self.pixel_mean) / self.pixel_std
        t = self.vision_model(x)
        for name in self.conv_names:
            t = getattr(self, name)(t)
        return t.reshape(t.shape[0], self.dim)


# -- MLPs, projector, head ------------------------------------------------------------


class MLPBlock(nn.Module):
    def __init__(self, n_in, n_out, dropout):
        super().__init__()
        self.lin = Linear(n_in, n_out)
        self.norm = BatchNorm(n_out, 1e-5, 0.9, rounds=False)
        self.do = Dropout(dropout)

    def forward(self, x):
        return F.relu(self.do(self.norm(self.lin(x))))


class ParamEmbed(nn.Module):
    def __init__(self, nparams, dim, dropout):
        super().__init__()
        self.block1 = MLPBlock(nparams, dim, dropout)
        self.block2 = MLPBlock(dim, dim, dropout)
        self.lin3 = Linear(dim, dim)

    def forward(self, x):
        return self.lin3(self.block2(self.block1(x)))


class Projector(nn.Module):
    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.n_hidden = len(dims) - 2
        for i in range(self.n_hidden):
            self.add_module(f"lin{i}", Linear(dims[i], dims[i + 1]))
            self.add_module(f"bn{i}", BatchNorm(dims[i + 1], 1e-5, 0.9))
        self.lin_final = Linear(dims[-2], dims[-1], bias=False)

    def forward(self, x):
        for i in range(self.n_hidden):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"lin{i}")(x)))
        return self.lin_final(x)


class VICReg(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dims = tuple(int(v) for v in (f"{cfg['dim']}-" + cfg["vicreg"]["mlp"] % cfg["embeddim"]).split("-"))
        self.backbone_audio = AudioEmbedding(cfg["dim"], (cfg["image"]["height"], cfg["image"]["width"]))
        self.backbone_param = ParamEmbed(cfg["nparams"], cfg["dim"], cfg["param_embed"]["dropout"])
        self.projector = Projector(dims)

    def forward(self, audio, params):
        return self.projector(self.backbone_audio(audio)), self.projector(self.backbone_param(params))


class Head(nn.Module):
    """Frozen audio representation -> 78 parameters in [0, 1]."""

    def __init__(self, nparams, dim, dropout):
        super().__init__()
        self.block1 = MLPBlock(dim, dim, dropout)
        self.block2 = MLPBlock(dim, dim, dropout)
        self.lin3 = Linear(dim, nparams)

    def forward(self, x):
        return torch.sigmoid(self.lin3(self.block2(self.block1(x))))


def vicreg_loss(x, y, sim_coeff, std_coeff, cov_coeff):
    """(loss, invariance, variance, covariance) over the batch."""
    n, d = x.shape
    repr_loss = torch.mean((x - y) ** 2)
    x = x - x.mean(0)
    y = y - y.mean(0)
    std_x = torch.sqrt(x.pow(2).sum(0) / (n - 1) + 1e-4)
    std_y = torch.sqrt(y.pow(2).sum(0) / (n - 1) + 1e-4)
    std_loss = torch.mean(F.relu(1 - std_x)) / 2 + torch.mean(F.relu(1 - std_y)) / 2
    cov_x = matmul(x.T, x) / (n - 1)
    cov_y = matmul(y.T, y) / (n - 1)

    def off(c):
        return c.pow(2).sum() - torch.diagonal(c).pow(2).sum()

    cov_loss = off(cov_x) / d + off(cov_y) / d
    return sim_coeff * repr_loss + std_coeff * std_loss + cov_coeff * cov_loss, repr_loss, std_loss, cov_loss
