"""MobileNetV3-Small feature trunk: NCHW [B, 3, H, W] -> [B, 576, H/32, W/32].

Counterpart of the JAX package's ``models/mobilenetv3.py`` (which runs NHWC):
explicit (k-1)//2 padding, BatchNorm eps 1e-3 with flax momentum 0.99 (torch
momentum 0.01), hardswish/hardsigmoid, and the same submodule names (stem,
bneck_i.block_j, head), so ``models/jax_weights.py`` maps the JAX tree by path.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from inverse_audio_synthesis_tpu_torch.models.layers import BatchNorm, conv2d


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


_ACTS = {"hardswish": hard_swish, "relu": F.relu, None: None}

# (kernel, exp, out, use_se, use_hs, stride) — MobileNetV3-Small layer plan
SMALL_CONFIG: Tuple[Tuple[int, int, int, bool, bool, int], ...] = (
    (3, 16, 16, True, False, 2),
    (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1),
    (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1),
    (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1),
    (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2),
    (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
)


class ConvBNAct(nn.Module):
    def __init__(self, in_ch, out_ch, kernel, stride=1, groups=1, act="hardswish",
                 bn_dtype=torch.float32, generator=None):
        super().__init__()
        pad = (kernel - 1) // 2
        self.conv = conv2d(in_ch, out_ch, kernel, stride, pad, groups, bias=False,
                           generator=generator)
        self.bn = BatchNorm(out_ch, eps=1e-3, momentum=0.99, out_dtype=bn_dtype)
        self.act = _ACTS[act]

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


class SqueezeExcitation(nn.Module):
    def __init__(self, channels: int, squeeze_channels: int, generator=None):
        super().__init__()
        self.fc1 = conv2d(channels, squeeze_channels, 1, generator=generator)
        self.fc2 = conv2d(squeeze_channels, channels, 1, generator=generator)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = F.relu(self.fc1(s))
        s = self.fc2(s)
        return x * hard_sigmoid(s)


class InvertedResidual(nn.Module):
    def __init__(self, in_ch, kernel, exp_ch, out_ch, use_se, use_hs, stride,
                 bn_dtype=torch.float32, generator=None):
        super().__init__()
        act = "hardswish" if use_hs else "relu"
        blocks = []
        if exp_ch != in_ch:
            blocks.append(ConvBNAct(in_ch, exp_ch, 1, act=act, bn_dtype=bn_dtype, generator=generator))
        blocks.append(ConvBNAct(exp_ch, exp_ch, kernel, stride=stride, groups=exp_ch, act=act,
                                bn_dtype=bn_dtype, generator=generator))
        if use_se:
            blocks.append(SqueezeExcitation(exp_ch, make_divisible(exp_ch // 4), generator))
        blocks.append(ConvBNAct(exp_ch, out_ch, 1, act=None, bn_dtype=bn_dtype, generator=generator))
        for i, blk in enumerate(blocks):
            self.add_module(f"block_{i}", blk)
        self.n_blocks = len(blocks)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        y = x
        for i in range(self.n_blocks):
            y = getattr(self, f"block_{i}")(y)
        return y + x if self.residual else y


class MobileNetV3Small(nn.Module):
    """``features`` trunk only: [B, 3, H, W] -> [B, 576, ceil-ish(H/32), ceil-ish(W/32)]."""

    def __init__(self, bn_dtype=torch.float32, generator=None):
        super().__init__()
        self.stem = ConvBNAct(3, 16, 3, stride=2, bn_dtype=bn_dtype, generator=generator)
        in_ch = 16
        for i, (k, exp, out, se, hs, s) in enumerate(SMALL_CONFIG):
            self.add_module(
                f"bneck_{i}",
                InvertedResidual(in_ch, k, exp, out, se, hs, s, bn_dtype=bn_dtype,
                                 generator=generator),
            )
            in_ch = out
        self.head = ConvBNAct(in_ch, 576, 1, bn_dtype=bn_dtype, generator=generator)

    def forward(self, x):
        x = self.stem(x)
        for i in range(len(SMALL_CONFIG)):
            x = getattr(self, f"bneck_{i}")(x)
        return self.head(x)


def feature_map_size(height: int, width: int) -> Tuple[int, int]:
    """Spatial size of the trunk's output for an H x W input."""

    def down(n: int, k: int) -> int:
        pad = (k - 1) // 2
        return (n + 2 * pad - k) // 2 + 1

    h, w = down(height, 3), down(width, 3)
    for k, _, _, _, _, s in SMALL_CONFIG:
        if s == 2:
            h, w = down(h, k), down(w, k)
    return h, w
