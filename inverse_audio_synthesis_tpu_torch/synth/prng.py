"""Threefry-2x32 keys and uniform draws, bit-identical to ``jax.random``.

The synth's data is born from a batch number: ``sample_voice_params`` draws the
[B, 78] parameters from ``fold_in(PRNGKey(seed), batch_num)`` and the fixed noise
buffer draws row ``i`` from ``fold_in(PRNGKey(noise_seed), i)``. Reproducing JAX's
bits here makes a batch number name the same voices and the same noise in both
packages, so the port can be held against the JAX package end to end.

The bit layout is that of JAX 0.9 with ``jax_threefry_partitionable=True`` (its
default): ``random_bits`` hashes the 64-bit flat index of each element, split
into (hi, lo) 32-bit counters, and XORs the two output words; ``uniform`` keeps
the top 23 bits as the mantissa of a float in [1, 2).

Words are held in int64 tensors masked to 32 bits: torch has no complete
unsigned 32-bit arithmetic, and int64 add/shift/xor run on every device.
A key is an int64 tensor of shape [2].
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(
    k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
):
    """The Threefry-2x32 hash (20 rounds), elementwise over x1/x2; keys broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the words (seed >> 32, seed),
    as a CPU tensor."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: hash the counter pair (0, uint32(data)).

    ``data`` may be an int or an int64 tensor of any shape; the result then has
    that shape plus a trailing 2 (one key per element)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    a, b = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int], device=None) -> torch.Tensor:
    """32-bit words of ``jax.random.bits(key, shape)`` on ``device`` (default: the
    key's). ``key`` may carry leading dims (one key each); the result is
    ``key.shape[:-1] + shape``. A single CPU key enters the hash as two Python
    ints, so drawing on the GPU copies nothing to it."""
    device = key.device if device is None else torch.device(device)
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    if key.dim() == 1 and key.device.type == "cpu":
        k1, k2 = (int(v) for v in key.tolist())
    else:
        lead = key.shape[:-1] + (1,) * len(shape)
        key = key.to(device)
        k1, k2 = key[..., 0].reshape(lead), key[..., 1].reshape(lead)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & _MASK)
    return b1 ^ b2


def uniform(
    key: torch.Tensor, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0,
    device=None,
) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``, bit for bit
    (per key, for a batch of keys)."""
    bits = random_bits(key, shape, device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = float(np.float32(minval)), float(np.float32(maxval))
    span = float(np.float32(hi - lo))
    return torch.clamp_min(floats * span + lo, lo)
