"""Parameter tower: MLP nparams -> dim -> dim -> dim.

Counterpart of the JAX package's ``models/paramembed.py``. Each hidden layer is
Linear -> {BatchNorm (eps 1e-5, flax momentum 0.9, float32) | identity} ->
Dropout -> ReLU; the final Linear is bare.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from inverse_audio_synthesis_tpu_torch.models.layers import BatchNorm, Dropout, dense


class MLPBlock(nn.Module):
    def __init__(self, in_features: int, features: int, hidden_norm: str = "nn.BatchNorm1d",
                 dropout: float = 0.1, generator=None):
        super().__init__()
        self.lin = dense(in_features, features, generator=generator)
        if hidden_norm == "nn.BatchNorm1d":
            self.norm = BatchNorm(features, eps=1e-5, momentum=0.9, out_dtype=torch.float32)
        elif hidden_norm == "nn.Identity":
            self.norm = None
        else:
            raise ValueError(f"unknown hidden_norm {hidden_norm!r}")
        self.do = Dropout(dropout)

    def forward(self, x):
        x = self.lin(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.relu(self.do(x))


class ParamEmbed(nn.Module):
    def __init__(self, nparams: int = 78, dim: int = 1024, hidden_norm: str = "nn.BatchNorm1d",
                 dropout: float = 0.1, generator=None):
        super().__init__()
        self.nparams = nparams
        self.block1 = MLPBlock(nparams, dim, hidden_norm, dropout, generator)
        self.block2 = MLPBlock(dim, dim, hidden_norm, dropout, generator)
        self.lin3 = dense(dim, dim, generator=generator)

    def forward(self, x):
        if x.shape[-1] != self.nparams:
            raise ValueError(f"expected {self.nparams} params, got {x.shape[-1]}")
        return self.lin3(self.block2(self.block1(x)))
