"""Carry weights between the JAX package's variable tree and the port's modules.

A JAX model's variables are ``{"params": tree, "batch_stats": tree}``, nested
dicts keyed by submodule name. The port's modules use the same submodule names,
so a leaf's path names its torch module. Layouts:

    Dense kernel [in, out]              <-> nn.Linear.weight [out, in]
    Conv kernel HWIO [kh, kw, in/g, out] <-> nn.Conv2d.weight OIHW [out, in/g, kh, kw]
    BatchNorm scale / bias               <-> BatchNorm.weight / bias
    batch_stats mean / var               <-> BatchNorm.running_mean / running_var

Everything here takes and returns numpy arrays; nothing imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from inverse_audio_synthesis_tpu_torch.models.layers import BatchNorm

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
    """(torch tensor, to_torch, to_jax) for one JAX leaf of ``mod``."""
    if isinstance(mod, nn.Linear) and collection == "params":
        if leaf == "kernel":
            return mod.weight, lambda a: a.T, lambda t: t.T
        if leaf == "bias":
            return mod.bias, None, None
    if isinstance(mod, nn.Conv2d) and collection == "params":
        if leaf == "kernel":
            return mod.weight, lambda a: a.transpose(3, 2, 0, 1), lambda t: t.transpose(2, 3, 1, 0)
        if leaf == "bias":
            return mod.bias, None, None
    if isinstance(mod, BatchNorm):
        names = {("params", "scale"): "weight", ("params", "bias"): "bias",
                 ("batch_stats", "mean"): "running_mean", ("batch_stats", "var"): "running_var"}
        if (collection, leaf) in names:
            return getattr(mod, names[(collection, leaf)]), None, None
    raise KeyError(f"{collection} leaf {leaf!r} has no counterpart in {type(mod).__name__}")


def load_jax_variables(module: nn.Module, variables: Tree) -> None:
    """Copy a JAX variable tree (numpy leaves) into ``module`` in place. Every
    leaf must land, and every tensor it names must match its shape."""
    with torch.no_grad():
        for collection in ("params", "batch_stats"):
            for path, value in _leaves(variables.get(collection, {})):
                tensor, to_torch, _ = _target(_module_at(module, path[:-1]), collection, path[-1])
                arr = np.asarray(value, dtype=np.float32)
                if to_torch is not None:
                    arr = to_torch(arr)
                if tuple(arr.shape) != tuple(tensor.shape):
                    raise ValueError(
                        f"{'/'.join(path)}: JAX shape {arr.shape} vs torch {tuple(tensor.shape)}"
                    )
                tensor.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))


def export_jax_variables(module: nn.Module, like: Tree) -> Tree:
    """The module's tensors as a JAX-layout tree with the structure of ``like``."""
    out: Tree = {}
    for collection in ("params", "batch_stats"):
        for path, _ in _leaves(like.get(collection, {})):
            tensor, _, to_jax = _target(_module_at(module, path[:-1]), collection, path[-1])
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
