"""Audio tower: audio -> PQMF pseudo-image -> MobileNetV3-Small -> conv stack -> [B, dim].

Counterpart of the JAX package's ``models/audioembed.py``: [B, 1, T] audio ->
PQMF(3 bands) -> [B, 3, H, W] (240 x 245 for 4 s) -> ImageNet normalize ->
trunk [B, 576, h, w] -> stacked 2 x 2 VALID convs (no activations between)
collapsing the map to 1 x 1 -> [B, dim]. The JAX tower reshapes the band-last
PQMF output to NHWC; here the band-first output reshapes straight to NCHW, which
holds the same pixels.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch
from torch import nn

from inverse_audio_synthesis_tpu_torch.models.layers import conv2d
from inverse_audio_synthesis_tpu_torch.models.mobilenetv3 import (
    MobileNetV3Small,
    feature_map_size,
)
from inverse_audio_synthesis_tpu_torch.ops.pqmf import PQMF

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@lru_cache(maxsize=8)
def _pqmf(n_bands: int) -> PQMF:
    return PQMF(n_bands=n_bands)


class AudioEmbedding(nn.Module):
    def __init__(self, dim: int = 1024, n_bands: int = 3,
                 image_size: Tuple[int, int] = (240, 245), bn_dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.dim = dim
        self.n_bands = n_bands
        # the filterbank is designed here, not at the first forward: a forward
        # traced by torch.export must find it made
        self.pqmf = _pqmf(n_bands)
        self.image_size = tuple(image_size)
        self.vision_model = MobileNetV3Small(bn_dtype=bn_dtype, generator=generator)
        h, w = feature_map_size(*self.image_size)
        self.conv_names = []
        in_ch = 576
        i = max(h, w) - 1
        while h > 1 or w > 1:
            kh = min(2, h) if h > 1 else 1
            kw = min(2, w) if w > 1 else 1
            self.add_module(f"conv{i}", conv2d(in_ch, dim, (kh, kw), generator=generator))
            self.conv_names.append(f"conv{i}")
            in_ch = dim
            h, w = h - kh + 1, w - kw + 1
            i -= 1
        if in_ch != dim:  # degenerate 1x1 feature maps skip the loop
            self.add_module("conv1", conv2d(in_ch, dim, 1, generator=generator))
            self.conv_names.append("conv1")
        self.register_buffer(
            "pixel_mean", torch.tensor(IMAGENET_MEAN).reshape(1, 3, 1, 1), persistent=False
        )
        self.register_buffer(
            "pixel_std", torch.tensor(IMAGENET_STD).reshape(1, 3, 1, 1), persistent=False
        )

    def preprocess(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, 1, T] -> normalized pseudo-image [B, 3, H, W] (float32)."""
        h, w = self.image_size
        z = self.pqmf.analysis(audio.float())  # [B, 3, T/3]
        if z.shape[1] * z.shape[2] != self.n_bands * h * w:
            raise ValueError(
                f"audio length {audio.shape[-1]} does not tile into {self.n_bands}x{h}x{w}"
            )
        zimg = z.reshape(-1, self.n_bands, h, w)
        return (zimg - self.pixel_mean) / self.pixel_std

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        if audio.dim() != 3 or audio.shape[1] != 1:
            raise ValueError(f"audio must be [B, 1, T], got {tuple(audio.shape)}")
        t = self.vision_model(self.preprocess(audio))
        for name in self.conv_names:
            t = getattr(self, name)(t)
        return t.reshape(t.shape[0], self.dim)
