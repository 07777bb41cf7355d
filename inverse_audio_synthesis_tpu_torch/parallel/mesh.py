"""The (data, model) mesh over the process group, and the projector's layout.

Counterpart of the JAX package's ``parallel/mesh.py``, with one process per rank
in place of GSPMD over one program:

- **data**: each rank holds ``global batch / data`` rows of every activation. The
  VICReg statistics, the BatchNorm statistics and the test metrics are taken over
  the global batch, and the gradients are summed over the data group.
- **model**: tensor parallelism of the projector. The hidden ``lin{i}`` are split
  by output column (their biases and ``bn{i}`` likewise), ``lin_final`` by input
  row; everything else is replicated.

Ranks are laid out as the JAX mesh reshapes its devices: rank = data_index *
model + model_index. The data group of a rank holds the ranks of its model index
(same parameter shard, other rows); its model group those of its data index
(same rows, other shards). Without a process group the mesh is (1, 1), has no
groups, and every module runs as it does on one device.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from inverse_audio_synthesis_tpu_torch.parallel.collectives import gather_shard


@dataclass(eq=False)
class Mesh:
    data: int = 1
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def distributed(self) -> bool:
        """True under a process group, of any size: collectives are real calls."""
        return self.data_group is not None

    @property
    def rank(self) -> int:
        return self.data_index * self.model + self.model_index

    @property
    def tensor_parallel(self) -> bool:
        return self.distributed and self.model > 1

    def local_rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch."""
        if global_batch % self.data:
            raise ValueError(f"global batch {global_batch} does not split over mesh.data={self.data}")
        n = global_batch // self.data
        return slice(self.data_index * n, (self.data_index + 1) * n)

    def __deepcopy__(self, memo):  # process groups are shared, never copied
        return self


def create_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The mesh of the current process group (the (1, 1) mesh without one).
    ``data=-1`` means world size / model. Every rank must call it, in the same
    order as its other group creations."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    data, model = int(data), int(model)
    if model < 1 or data == 0 or data < -1:
        raise ValueError(f"mesh data={data} model={model}: model >= 1 and data >= 1 or -1")
    if data == -1:
        if world % model:
            raise ValueError(f"mesh data=-1 x model={model} needs a multiple of {model} ranks, "
                             f"but the process group has {world}")
        data = world // model
    if data * model != world:
        raise ValueError(
            f"mesh data={data} x model={model} = {data * model} ranks, but the process group "
            f"has {world}"
        )
    if not dist.is_initialized():
        return Mesh()
    data_index, model_index = divmod(dist.get_rank(), model)
    mesh = Mesh(data, model, data_index, model_index)
    for m in range(model):  # every rank creates every group, in one order
        group = dist.new_group([d * model + m for d in range(data)])
        if m == model_index:
            mesh.data_group = group
    for d in range(data):
        group = dist.new_group([d * model + m for m in range(model)])
        if d == data_index:
            mesh.model_group = group
    return mesh


# -- the projector's layout --------------------------------------------------------

_SPLIT_BY_OUTPUT = re.compile(r"(^|\.)projector\.(lin\d+\.(weight|bias)|bn\d+\.\w+)$")
_SPLIT_BY_INPUT = re.compile(r"(^|\.)projector\.lin_final\.weight$")


def split_dim(name: str) -> Optional[int]:
    """The dim along which the model group splits the tensor ``name`` (a
    state-dict key, torch layout: Linear.weight is [out, in]), or None when it is
    replicated. The JAX rule (``_projector_spec``) in torch's layout."""
    if _SPLIT_BY_OUTPUT.search(name):
        return 0
    if _SPLIT_BY_INPUT.search(name):
        return 1
    return None


def shard(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a full tensor split ``dim``-wise over the model group."""
    if t.shape[dim] % mesh.model:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over mesh.model={mesh.model}")
    return t.chunk(mesh.model, dim)[mesh.model_index].contiguous()


def apply_mesh(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Attach the mesh to every module that reads it (BatchNorm, Dropout, the
    projector) and, under tensor parallelism, keep only this rank's shard of each
    split tensor. Call it once, on the full model every rank built from the seed."""
    if not mesh.distributed:
        return module
    for m in module.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh
    if mesh.tensor_parallel:
        with torch.no_grad():
            for name, t in list(module.state_dict(keep_vars=True).items()):
                dim = split_dim(name)
                if dim is not None:
                    t.data = shard(t.data, dim, mesh)
    return module


def full_state_dict(module: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The unsharded state dict on the host: each split tensor gathered over the
    model group (a collective: every rank of the group calls it)."""
    return gather_state(module.state_dict(), mesh)


def gather_state(state: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """``full_state_dict`` of a state dict: a module's, or an optimizer's, whose
    per-parameter entries end in the parameter's name."""
    out = {}
    for name, t in state.items():
        dim = split_dim(name) if mesh.tensor_parallel else None
        if dim is not None:
            t = gather_shard(t, dim, mesh)
        out[name] = t.detach().to("cpu", copy=True)
    return out


def local_state_dict(full: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's shard of an unsharded state dict."""
    if not mesh.tensor_parallel:
        return full
    out = {}
    for name, t in full.items():
        dim = split_dim(name)
        out[name] = shard(t, dim, mesh) if dim is not None else t
    return out


def split_flags(module: nn.Module, mesh: Mesh) -> Tuple[bool, ...]:
    """Per parameter of ``module.parameters()``: whether the model group splits it."""
    return tuple(
        mesh.tensor_parallel and split_dim(name) is not None
        for name, _ in module.named_parameters()
    )
