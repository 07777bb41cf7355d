"""Affine byte quantization of PQMF grams.

Counterpart of the JAX package's ``ops/imgscale8.py``: the min/max constants are
the empirical PQMF output range over 32K torchsynth sounds. The audio tower does
not use it (as in the reference and the JAX package); it is kept for parity.
"""

from __future__ import annotations

import torch

maxval = 1.5680482
minval = -1.6843455


def scale8(x: torch.Tensor, xmin: float = minval, xmax: float = maxval) -> torch.Tensor:
    """(x - xmin) / (xmax - xmin) * 255, clipped to [0, 255] and truncated to uint8.
    The span is a 0-dim float32 tensor: on CUDA torch turns division by a Python
    scalar into multiplication by its reciprocal, which JAX's division is not."""
    span = torch.full((), xmax - xmin, dtype=torch.float32, device=x.device)
    xscale = (x - xmin) / span * 255.0
    return torch.clamp(xscale, 0, 255).to(torch.uint8)


def unscale8(x: torch.Tensor, xmin: float = minval, xmax: float = maxval) -> torch.Tensor:
    return x.to(torch.float32) / 255.0 * (xmax - xmin) + xmin
