"""Pseudo-QMF analysis filterbank (the audio tower's front end).

Counterpart of the JAX package's ``ops/pqmf.py``: a Kaiser-window FIR prototype
lowpass, cosine-modulated into ``n_bands`` analysis filters H; analysis is a
strided cross-correlation (stride n_bands, padding taps//2). Filter design runs
once on the host with scipy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as sig


def design_pqmf_filters(
    n_bands: int, taps: int, cutoff: float, beta: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Cosine-modulated filterbank design. Returns (H, G), each [n_bands, taps + 1]
    float64."""
    proto = sig.firwin(taps + 1, cutoff, window=("kaiser", beta))
    k = np.arange(n_bands, dtype=np.float64)[:, None]
    t = np.arange(taps + 1, dtype=np.float64)[None, :]
    # NB: the reference centers the modulation at (taps - 1) / 2, not taps / 2
    # (acknowledged TODO at reference pqmf.py:26); kept for parity.
    mod = (2.0 * k + 1.0) * (np.pi / (2.0 * n_bands)) * (t - (taps - 1) / 2.0)
    phase = ((-1.0) ** k) * (np.pi / 4.0)
    analysis = 2.0 * proto * np.cos(mod + phase)
    synthesis = 2.0 * proto * np.cos(mod - phase)
    return analysis, synthesis


class PQMF:
    """``analysis(x)``: [B, 1, T] -> [B, n_bands, T / n_bands]
    (or [B, T / n_bands, n_bands] with ``channels_last``)."""

    def __init__(self, n_bands: int = 4, taps: int = 62, cutoff: float = 0.15, beta: float = 9.0):
        self.n_bands = n_bands
        self.taps = taps
        h, _ = design_pqmf_filters(n_bands, taps, cutoff, beta)
        self.H = torch.from_numpy(np.asarray(h[:, None, :], dtype=np.float32))  # [N, 1, K]
        self._h_on = {}  # (device, dtype) -> H there, copied once

    def _filters(self, x: torch.Tensor) -> torch.Tensor:
        if torch.compiler.is_compiling():  # tracing (torch.export): keep the copy out of the cache
            return self.H.to(device=x.device, dtype=x.dtype)
        key = (x.device, x.dtype)
        if key not in self._h_on:
            self._h_on[key] = self.H.to(device=x.device, dtype=x.dtype)
        return self._h_on[key]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.analysis(x)

    def analysis(self, x: torch.Tensor, channels_last: bool = False) -> torch.Tensor:
        """Runs in x's dtype with autocast off, as the JAX function runs in x's
        dtype whatever the towers' precision."""
        with torch.autocast(device_type=x.device.type, enabled=False):
            z = F.conv1d(x, self._filters(x), stride=self.n_bands, padding=self.taps // 2)
        return z.transpose(1, 2) if channels_last else z
