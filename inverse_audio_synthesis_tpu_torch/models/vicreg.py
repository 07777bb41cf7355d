"""VICReg: a shared projector over both towers, and the variance-invariance-covariance loss.

Counterpart of the JAX package's ``models/vicreg.py``. Under a mesh with
``model > 1`` the projector is tensor-parallel (``parallel/mesh.py``): each hidden
``lin{i}`` and ``bn{i}`` holds this rank's output columns, ``lin_final`` its input
rows. The input goes in through ``copy_to``, each later hidden layer takes the
whole previous activation through ``gather_cols``, and the row-split product
leaves through ``reduce_from``: one ``all_reduce`` per layer, each way. The loss
takes its statistics over the global batch (``gather_rows`` over the data
group), as the JAX package computes them over the logical global batch.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from inverse_audio_synthesis_tpu_torch.models.layers import BatchNorm, dense
from inverse_audio_synthesis_tpu_torch.parallel.collectives import (
    copy_to,
    gather_cols,
    gather_rows,
    reduce_from,
)


def parse_projector_spec(mlp: str, reprdim: int, embeddim: int) -> Tuple[int, ...]:
    """'8192-8192-%d' % embeddim prefixed with reprdim -> (1024, 8192, 8192, 8192)."""
    spec = f"{reprdim}-{mlp}" % embeddim
    return tuple(int(v) for v in spec.split("-"))


class Projector(nn.Module):
    """Linear + BatchNorm (eps 1e-5, flax momentum 0.9) + ReLU per hidden layer,
    bias-free final Linear."""

    mesh = None

    def __init__(self, dims: Sequence[int], bn_dtype=torch.float32, generator=None):
        super().__init__()
        dims = tuple(dims)
        self.n_hidden = len(dims) - 2
        for i in range(self.n_hidden):
            self.add_module(f"lin{i}", dense(dims[i], dims[i + 1], generator=generator))
            self.add_module(f"bn{i}", BatchNorm(dims[i + 1], eps=1e-5, momentum=0.9,
                                                out_dtype=bn_dtype))
        self.lin_final = dense(dims[-2], dims[-1], bias=False, generator=generator)

    def forward(self, x):
        mesh = self.mesh
        if mesh is None or not mesh.tensor_parallel:
            for i in range(self.n_hidden):
                x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"lin{i}")(x)))
            return self.lin_final(x)
        if self.n_hidden < 1:
            raise ValueError("a tensor-parallel projector needs a hidden layer")
        x = copy_to(x, mesh.model_group)
        for i in range(self.n_hidden):
            if i:
                x = gather_cols(x, mesh)
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"lin{i}")(x)))
        return reduce_from(self.lin_final(x), mesh.model_group)


class VICRegModule(nn.Module):
    """Both towers projected through one shared projector."""

    def __init__(self, backbone_audio: nn.Module, backbone_param: nn.Module,
                 projector_dims: Sequence[int], bn_dtype=torch.float32, generator=None):
        super().__init__()
        self.backbone_audio = backbone_audio
        self.backbone_param = backbone_param
        self.projector = Projector(projector_dims, bn_dtype=bn_dtype, generator=generator)

    def forward(self, audio, params):
        x = self.projector(self.backbone_audio(audio))
        y = self.projector(self.backbone_param(params))
        return x, y

    def embed_audio(self, audio):
        return self.projector(self.backbone_audio(audio))

    def embed_params(self, params):
        return self.projector(self.backbone_param(params))

    def audio_repr(self, audio):
        return self.backbone_audio(audio)

    def param_repr(self, params):
        return self.backbone_param(params)


def off_diagonal_sq_sum(c: torch.Tensor) -> torch.Tensor:
    """Sum of the squared off-diagonal entries of a square matrix: the covariance
    term's reference form (``vicreg_loss`` takes the diagonal from its operands)."""
    return torch.sum(c**2) - torch.sum(torch.diagonal(c) ** 2)


def vicreg_loss(
    x: torch.Tensor,
    y: torch.Tensor,
    sim_coeff: float = 25.0,
    std_coeff: float = 25.0,
    cov_coeff: float = 1.0,
    cov_batch_size: Optional[int] = None,
    cov_operand_dtype: Optional[torch.dtype] = None,
    mesh=None,
):
    """Returns (loss, repr_loss, std_loss, cov_loss) over the batch, in float32.

    ``cov_batch_size`` reproduces the reference's normalization by its config
    batch size; ``cov_operand_dtype`` (e.g. bf16) rounds the covariance operands
    to that type while the products accumulate in float32. Under a distributed
    ``mesh``, x and y are this rank's rows: the loss is taken over the global
    batch, identically on every rank."""
    with torch.autocast(device_type=x.device.type, enabled=False):
        x, y = x.float(), y.float()
        if mesh is not None:
            x, y = gather_rows(x, mesh), gather_rows(y, mesh)
        embeddim = x.shape[-1]
        n = x.shape[0]
        repr_loss = torch.mean((x - y) ** 2)
        x = x - x.mean(dim=0)
        y = y - y.mean(dim=0)
        std_x = torch.sqrt(torch.sum(x**2, dim=0) / (n - 1) + 1e-4)
        std_y = torch.sqrt(torch.sum(y**2, dim=0) / (n - 1) + 1e-4)
        std_loss = torch.mean(F.relu(1.0 - std_x)) / 2.0 + torch.mean(F.relu(1.0 - std_y)) / 2.0

        denom = (cov_batch_size if cov_batch_size is not None else n) - 1
        if cov_operand_dtype is not None:
            xc = x.to(cov_operand_dtype).float()
            yc = y.to(cov_operand_dtype).float()
        else:
            xc, yc = x, y
        cov_x = (xc.T @ xc) / denom
        cov_y = (yc.T @ yc) / denom

        def off_diag_sq(c, op):
            diag = torch.sum(op * op, dim=0) / denom
            return torch.sum(c**2) - torch.sum(diag**2)

        cov_loss = off_diag_sq(cov_x, xc) / embeddim + off_diag_sq(cov_y, yc) / embeddim
        loss = sim_coeff * repr_loss + std_coeff * std_loss + cov_coeff * cov_loss
    return loss, repr_loss, std_loss, cov_loss


def exclude_bias_and_norm(name: str, tensor: torch.Tensor) -> bool:
    """LARS's mask: True for the tensors it adapts and decays, those of more than
    one dim; biases and norm scales (1-D) are left out (reference: vicreg.py:98-99)."""
    return tensor.dim() > 1
