"""Autograd collectives built on ``all_reduce`` alone.

``torch.distributed``'s gloo backend runs only ``broadcast`` and ``all_reduce``
on CUDA tensors, and ``torch.distributed.nn``'s autograd ``all_gather`` takes its
gradient through ``all_to_all``, which gloo lacks there. Every op here is a sum:
NCCL runs it, and so does gloo with several ranks on one card. Each sum is taken
in float32, whatever the tensor's type, and cast back.

The two primitives are Megatron's pair:

- ``copy_to(x, group)``: identity forward, ``all_reduce`` backward. Where the
  group's ranks each consume the same value in their own way (the input of a
  column-split layer), the gradients are partial and must be summed;
- ``reduce_from(x, group)``: ``all_reduce`` forward, identity backward. Where
  every rank goes on with the sum in the same way (the output of a row-split
  layer, a loss computed identically on every rank), each rank's gradient is
  already the whole one.

Built from them:

- ``sum_over(x, group) = copy_to(reduce_from(x))``: ``all_reduce`` both ways, for
  sums that each rank then consumes with its own rows (BatchNorm statistics);
- ``gather_rows(x, mesh)``: the global batch over the data group. Each rank fills
  its slot of a zero buffer, then ``reduce_from``: exact, since every element is
  one rank's value plus zeros. Its backward keeps the rank's slot of the incoming
  gradient, because what follows (the VICReg loss) is computed identically on
  every rank and so hands each rank the whole gradient;
- ``gather_cols(x, index, n, group)``: the feature-split activation made whole
  over the model group, as ``sum_over`` of the padded shard: the layer after it
  is column-split, so each rank's gradient is partial.

**Counting the gradient.** A loss is computed identically on every rank of the
data group, from tensors that ``gather_rows`` or ``reduce_from`` made global.
Each rank's backward then yields the gradient of the global loss through its
own rows only, and the gradients are summed over the data group
(``train/optim.py:reduce_gradients``), never averaged: each row's contribution
is counted once. The model group never reduces parameter gradients: each rank
owns its shard.

``all_reduce_counts`` counts the calls and bytes of every ``all_reduce`` issued
here, for ``chip_smoke.py``'s per-step figures.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

all_reduce_counts = {"calls": 0, "bytes": 0}


def reset_all_reduce_counts() -> None:
    for k in all_reduce_counts:
        all_reduce_counts[k] = 0


def all_reduce_(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place ``all_reduce`` of a contiguous tensor, counted."""
    dist.all_reduce(t, op=op, group=group)
    all_reduce_counts["calls"] += 1
    all_reduce_counts["bytes"] += t.numel() * t.element_size()
    return t


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    y = x.detach().to(torch.float32, copy=True).contiguous()
    return all_reduce_(y, group).to(x.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    return copy_to(reduce_from(x, group), group)


def _pad_slot(x: torch.Tensor, dim: int, index: int, n: int) -> torch.Tensor:
    """``x`` in slot ``index`` of ``n`` equal slots along ``dim``, zeros elsewhere
    (differentiable: the backward keeps the slot)."""
    k = x.shape[dim]
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [index * k, (n - 1 - index) * k]
    return torch.nn.functional.pad(x, pad)


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch [data * B, ...] from each rank's rows [B, ...]."""
    if not mesh.distributed:
        return x
    return reduce_from(_pad_slot(x, 0, mesh.data_index, mesh.data), mesh.data_group)


def gather_cols(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole feature dim (last) from each model rank's shard."""
    return sum_over(_pad_slot(x, -1, mesh.model_index, mesh.model), mesh.model_group)


def global_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the data group of per-rank partial sums, for a value every
    rank goes on with identically (a loss or a metric): ``reduce_from``."""
    return reduce_from(x, mesh.data_group) if mesh.distributed else x


@torch.no_grad()
def gather_shard(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The full tensor from each model rank's ``dim``-wise shard (no gradient)."""
    return _summed(_pad_slot(t, dim, mesh.model_index, mesh.model), mesh.model_group)


def _control_device() -> torch.device:
    """Where small control values travel: NCCL needs the card, gloo takes the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def agree_max(value: Optional[float], mesh) -> Optional[float]:
    """The largest of every rank's ``value`` (None counts as absent), on every
    rank: e.g. the signal one rank received, so that all stop at one step."""
    if not mesh.distributed:
        return value
    t = torch.tensor([-1.0 if value is None else float(value)], device=_control_device())
    all_reduce_(t, op=dist.ReduceOp.MAX)
    v = float(t.item())
    return None if v < 0 else v


def barrier(mesh) -> None:
    if mesh.distributed:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
