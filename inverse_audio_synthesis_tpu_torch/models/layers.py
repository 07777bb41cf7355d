"""Layers shared by the towers, with flax.linen's semantics.

- ``BatchNorm``: statistics in float32 as E[x^2] - E[x]^2 (flax's fast variance),
  running statistics updated with flax's momentum convention
  (ra = momentum * ra + (1 - momentum) * batch_stat) and the *biased* batch
  variance, where torch's own BatchNorm uses the unbiased one. The normalized
  output is cast to ``out_dtype`` (bf16 under ``bn_bf16``). With
  ``update_stats`` False, train mode normalizes on the batch and leaves the
  running statistics as they are (flax's train=True with the mutated
  batch_stats discarded).
- ``Dropout``: flax's ``where(keep, x / keep_prob, 0)``, drawing its mask from an
  explicit ``torch.Generator`` when one is set.
- Under a distributed mesh (``parallel/mesh.py:apply_mesh`` sets ``mesh``), train
  mode BatchNorm takes its statistics over the global batch of its data group, as
  flax does under GSPMD: per-rank sums of x and x^2, one ``sum_over`` (whose
  backward sums the statistics' partial gradients), then the same E[x^2] - E[x]^2.
  The running statistics stay identical on every rank of the group. Dropout draws
  the mask of the global batch, as one rank would, and keeps its rows: the mask
  does not depend on the mesh.
- ``Linear``/``Conv2d`` (made by ``dense``/``conv2d``): compute in their input's
  dtype whatever their weights' storage dtype, as flax's ``promote_dtype`` does:
  under ``weights_bf16`` the >=2-D weights are stored in bf16, and outside
  autocast (``precision: f32``) they are cast to the float32 input; under autocast
  torch casts both operands to bf16 itself.
- ``lecun_normal_``: flax's default kernel init (truncated normal, fan-in).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from inverse_audio_synthesis_tpu_torch.parallel.collectives import sum_over


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """variance_scaling(1, fan_in, truncated_normal): std = sqrt(1/fan_in) / .8796."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 (channels/features) with flax.linen's semantics."""

    mesh = None

    def __init__(self, num_features: int, eps: float, momentum: float, out_dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.momentum = momentum  # flax convention: weight of the OLD running value
        self.out_dtype = out_dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.float()
        if self.training:
            dims = [0] + list(range(2, x.dim()))
            count = xf.numel() // xf.shape[1]
            sums = torch.stack([xf.sum(dims), (xf * xf).sum(dims)])
            if self.mesh is not None:
                sums = sum_over(sums, self.mesh.data_group)
                count *= self.mesh.data
            mean, mean2 = (sums / count).unbind(0)
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            if self.update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                    self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(self.out_dtype)


class Dropout(nn.Module):
    """flax.linen.Dropout: keep with probability 1 - rate and scale by 1/keep_prob."""

    mesh = None

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        if self.mesh is None:
            u = torch.rand(x.shape, generator=self.generator, device=x.device)
        else:  # the global batch's mask, this rank's rows
            b = x.shape[0]
            u = torch.rand((b * self.mesh.data, *x.shape[1:]), generator=self.generator, device=x.device)
            u = u[self.mesh.local_rows(b * self.mesh.data)]
        return torch.where(u < keep_prob, x / keep_prob, torch.zeros_like(x))


def _as_input(t: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    """A weight in x's dtype outside autocast; as it is otherwise."""
    if t is None or t.dtype == x.dtype or torch.is_autocast_enabled(x.device.type):
        return t
    return t.to(x.dtype)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, _as_input(self.weight, x), _as_input(self.bias, x))


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, _as_input(self.weight, x), _as_input(self.bias, x))


def dense(in_features: int, out_features: int, bias: bool = True, generator=None) -> Linear:
    """Linear with flax.linen.Dense's init (lecun normal kernel, zero bias)."""
    lin = Linear(in_features, out_features, bias=bias)
    lecun_normal_(lin.weight, in_features, generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


def conv2d(
    in_ch: int, out_ch: int, kernel, stride: int = 1, padding=0, groups: int = 1,
    bias: bool = True, generator=None,
) -> Conv2d:
    """Conv2d with flax.linen.Conv's init."""
    conv = Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, groups=groups, bias=bias)
    kh, kw = conv.kernel_size
    lecun_normal_(conv.weight, in_ch // groups * kh * kw, generator)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv
