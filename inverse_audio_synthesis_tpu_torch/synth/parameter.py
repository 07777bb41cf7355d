"""Normalized-parameter specs with curve warping (torchsynth's ``ModuleParameterRange``).

    non-symmetric:  v = min + (max - min) * x**curve
    symmetric:      d = 2x - 1;  v = min + (max - min) * (sign(d) * |d|**curve + 1) / 2

``to_0to1`` is the inverse, with the powers 1/curve. Counterpart of the JAX
package's ``synth/parameter.py``, with the same masked "safe power" in both
directions: the base is replaced by 1 where it is 0, so the gradient of
``x**curve`` stays finite at x = 0 for curve < 1.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ParamSpec:
    module: str
    name: str
    minimum: float
    maximum: float
    curve: float = 1.0
    symmetric: bool = False


def _safe_pow(base: torch.Tensor, exponent: float) -> torch.Tensor:
    positive = base > 0.0
    safe = torch.where(positive, base, torch.ones_like(base))
    return torch.where(positive, torch.pow(safe, exponent), torch.zeros_like(base))


def from_0to1(spec: ParamSpec, x: torch.Tensor) -> torch.Tensor:
    """Normalized [0,1] -> natural units."""
    if not spec.symmetric:
        if spec.curve != 1.0:
            x = _safe_pow(x, spec.curve)
        return spec.minimum + (spec.maximum - spec.minimum) * x
    dist = 2.0 * x - 1.0
    warped = torch.sign(dist) * _safe_pow(torch.abs(dist), spec.curve)
    return spec.minimum + (spec.maximum - spec.minimum) * (warped + 1.0) / 2.0


def to_0to1(spec: ParamSpec, v: torch.Tensor) -> torch.Tensor:
    """Natural units -> normalized [0,1] (the inverse of ``from_0to1``)."""
    if not spec.symmetric:
        x = (v - spec.minimum) / (spec.maximum - spec.minimum)
        if spec.curve != 1.0:
            x = _safe_pow(x, 1.0 / spec.curve)
        return x
    d = 2.0 * (v - spec.minimum) / (spec.maximum - spec.minimum) - 1.0
    x = torch.sign(d) * _safe_pow(torch.abs(d), 1.0 / spec.curve)
    return (x + 1.0) / 2.0
