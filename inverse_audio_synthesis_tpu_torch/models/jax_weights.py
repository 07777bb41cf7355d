"""Carry weights between the JAX package's variable tree and the port's modules.

A JAX model's variables are ``{"params": tree, "batch_stats": tree}``, nested
dicts keyed by submodule name. The port's modules use the same submodule names,
so a leaf's path names its torch module. Layouts:

    Dense kernel [in, out]              <-> nn.Linear.weight [out, in]
    Conv kernel HWIO [kh, kw, in/g, out] <-> nn.Conv2d.weight OIHW [out, in/g, kh, kw]
    BatchNorm scale / bias               <-> BatchNorm.weight / bias
    batch_stats mean / var               <-> BatchNorm.running_mean / running_var

Under a tensor-parallel mesh (``parallel/mesh.py``) a rank's module holds its
shard of each split projector tensor: ``load_jax_variables`` keeps the rank's
slice of the full JAX array, and ``export_jax_variables`` returns the full tree,
each split tensor gathered over the model group (every rank of the group calls it).

Everything here takes and returns numpy arrays; nothing imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from inverse_audio_synthesis_tpu_torch.models.layers import BatchNorm
from inverse_audio_synthesis_tpu_torch.parallel.collectives import gather_shard
from inverse_audio_synthesis_tpu_torch.parallel.mesh import Mesh, shard, split_dim

Tree = Dict[str, Any]


def _leaves(tree: Tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_at(root: nn.Module, path: Tuple[str, ...]) -> nn.Module:
    mod = root
    for name in path:
        child = getattr(mod, name, None)
        if not isinstance(child, nn.Module):
            raise KeyError(f"no submodule {'.'.join(path)} in {type(root).__name__}")
        mod = child
    return mod


def _target(mod: nn.Module, collection: str, leaf: str):
    """(torch attribute name, to_torch, to_jax) for one JAX leaf of ``mod``."""
    if isinstance(mod, nn.Linear) and collection == "params":
        if leaf == "kernel":
            return "weight", lambda a: a.T, lambda t: t.T
        if leaf == "bias":
            return "bias", None, None
    if isinstance(mod, nn.Conv2d) and collection == "params":
        if leaf == "kernel":
            return "weight", lambda a: a.transpose(3, 2, 0, 1), lambda t: t.transpose(2, 3, 1, 0)
        if leaf == "bias":
            return "bias", None, None
    if isinstance(mod, BatchNorm):
        names = {("params", "scale"): "weight", ("params", "bias"): "bias",
                 ("batch_stats", "mean"): "running_mean", ("batch_stats", "var"): "running_var"}
        if (collection, leaf) in names:
            return names[(collection, leaf)], None, None
    raise KeyError(f"{collection} leaf {leaf!r} has no counterpart in {type(mod).__name__}")


def _split(path: Tuple[str, ...], attr: str, mesh: Optional[Mesh]) -> Optional[int]:
    """The dim the model group splits this leaf's torch tensor along, or None."""
    if mesh is None or not mesh.tensor_parallel:
        return None
    return split_dim(".".join(path[:-1] + (attr,)))


def load_jax_variables(module: nn.Module, variables: Tree, mesh: Optional[Mesh] = None) -> None:
    """Copy a JAX variable tree (numpy leaves) into ``module`` in place (this
    rank's shard of each split tensor under ``mesh``). Every leaf must land, and
    every tensor it names must match its shape."""
    with torch.no_grad():
        for collection in ("params", "batch_stats"):
            for path, value in _leaves(variables.get(collection, {})):
                attr, to_torch, _ = _target(_module_at(module, path[:-1]), collection, path[-1])
                tensor = getattr(_module_at(module, path[:-1]), attr)
                arr = np.asarray(value, dtype=np.float32)
                if to_torch is not None:
                    arr = to_torch(arr)
                t = torch.from_numpy(np.array(arr, dtype=np.float32))
                dim = _split(path, attr, mesh)
                if dim is not None:
                    t = shard(t, dim, mesh)
                if tuple(t.shape) != tuple(tensor.shape):
                    raise ValueError(
                        f"{'/'.join(path)}: JAX shape {arr.shape} vs torch {tuple(tensor.shape)}"
                    )
                tensor.copy_(t)


def export_jax_variables(module: nn.Module, like: Tree, mesh: Optional[Mesh] = None) -> Tree:
    """The module's tensors as a JAX-layout tree with the structure of ``like``
    (full tensors: split ones gathered over ``mesh``'s model group)."""
    out: Tree = {}
    for collection in ("params", "batch_stats"):
        for path, _ in _leaves(like.get(collection, {})):
            attr, _, to_jax = _target(_module_at(module, path[:-1]), collection, path[-1])
            tensor = getattr(_module_at(module, path[:-1]), attr)
            dim = _split(path, attr, mesh)
            if dim is not None:
                tensor = gather_shard(tensor, dim, mesh)
            arr = tensor.detach().float().cpu().numpy()
            if to_jax is not None:
                arr = to_jax(arr)
            node = out.setdefault(collection, {})
            for name in path[:-1]:
                node = node.setdefault(name, {})
            node[path[-1]] = np.ascontiguousarray(arr)
    return out


def flatten(tree: Tree) -> Dict[str, np.ndarray]:
    """{"a/b/kernel": array} view of a nested tree, for comparisons."""
    return {"/".join(p): np.asarray(v) for p, v in _leaves(tree)}
