"""Downstream inverse-synthesis head: frozen audio representation -> 78 synth params.

Counterpart of the JAX package's ``models/audio_to_params.py``: MLP dim -> dim ->
dim -> nparams with a sigmoid output, for the normalized 0-1 parameter space. The
hidden blocks are the parameter tower's ``MLPBlock`` (Linear -> BatchNorm or
identity -> Dropout -> ReLU).
"""

from __future__ import annotations

import torch
from torch import nn

from inverse_audio_synthesis_tpu_torch.models.layers import dense
from inverse_audio_synthesis_tpu_torch.models.paramembed import MLPBlock


class AudioRepresentationToParams(nn.Module):
    def __init__(self, nparams: int = 78, dim: int = 1024, hidden_norm: str = "nn.BatchNorm1d",
                 dropout: float = 0.1, generator=None):
        super().__init__()
        self.block1 = MLPBlock(dim, dim, hidden_norm, dropout, generator)
        self.block2 = MLPBlock(dim, dim, hidden_norm, dropout, generator)
        self.lin3 = dense(dim, nparams, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.lin3(self.block2(self.block1(x))))
