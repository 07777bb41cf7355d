"""The weights both sides start from, made on the device from the seed.

One normal draw of every parameter's values at once; each matrix or kernel is
scaled by 1/sqrt(fan-in) (fan-in: the product of all dims but the first),
BatchNorm scales are 1 and biases 0. Buffers (running statistics) keep their
initial values, mean 0 and variance 1, on both sides.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import towers as T


def shapes(module: torch.nn.Module):
    """[(name, shape, kind)] of a module's parameters, kind one of scaled/ones/zeros."""
    ones = set()
    for prefix, m in module.named_modules():
        if isinstance(m, T.BatchNorm):
            ones.add(f"{prefix}.weight" if prefix else "weight")
    out = []
    for name, p in module.named_parameters():
        kind = "scaled" if p.dim() >= 2 else ("ones" if name in ones else "zeros")
        out.append((name, tuple(p.shape), kind))
    return out


def make(module: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device`` for every parameter of ``module``
    (a reference module, on any device, ``meta`` included)."""
    spec = shapes(module)
    sizes = [int(torch.Size(s).numel()) for _, s, k in spec if k == "scaled"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    chunks = iter(flat.split(sizes))
    out = {}
    for name, shape, kind in spec:
        if kind == "scaled":
            fan_in = int(torch.Size(shape[1:]).numel())
            out[name] = next(chunks).view(shape).mul_(fan_in ** -0.5)
        else:
            out[name] = (torch.ones if kind == "ones" else torch.zeros)(shape, device=device)
    return out


@torch.no_grad()
def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the same-named parameters of a module of the
    measured program, in place (every parameter must be named, with its shape)."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        differ = sorted(set(params) ^ set(weights))
        raise KeyError(f"the program's parameters and the benchmark's weights differ: {differ[:6]}")
    for name, w in weights.items():
        p = params[name]
        if tuple(p.shape) != tuple(w.shape):
            raise ValueError(f"{name}: program shape {tuple(p.shape)}, weights {tuple(w.shape)}")
        p.copy_(w.to(p.dtype))
