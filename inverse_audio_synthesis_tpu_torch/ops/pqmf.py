"""Pseudo-QMF analysis/synthesis filterbank (the audio tower's front end).

Counterpart of the JAX package's ``ops/pqmf.py``: a Kaiser-window FIR prototype
lowpass, cosine-modulated into ``n_bands`` analysis filters H and synthesis
filters G. Analysis is a strided cross-correlation (stride n_bands, padding
taps//2). Synthesis is the reference's direct form: each band zero-stuffed by
n_bands with gain n_bands (``conv_transpose1d``), then one cross-correlation with
G summing over the bands. The JAX package regroups synthesis into n_bands
band-rate convolutions, a workaround for the TPU compiler's slowness on a stride-1
convolution over the full-rate signal; the sums are the same up to float32
association (within 1e-4, ``tests/test_pqmf.py``'s bound). Filter design runs
once on the host with scipy; both directions run with autocast off.
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
    (or [B, T / n_bands, n_bands] with ``channels_last``);
    ``synthesis(x)``: [B, n_bands, T'] -> [B, 1, T' * n_bands]."""

    def __init__(self, n_bands: int = 4, taps: int = 62, cutoff: float = 0.15, beta: float = 9.0):
        self.n_bands = n_bands
        self.taps = taps
        h, g = design_pqmf_filters(n_bands, taps, cutoff, beta)
        self.H = torch.from_numpy(np.asarray(h[:, None, :], dtype=np.float32))  # [N, 1, K]
        self.G = torch.from_numpy(np.asarray(g[None, :, :], dtype=np.float32))  # [1, N, K]
        # zero-stuffing filter: band i to channel i, gain n_bands at tap 0
        self.U = torch.zeros((n_bands, n_bands, n_bands))
        self.U[range(n_bands), range(n_bands), 0] = float(n_bands)
        self._on = {}  # (name, device, dtype) -> that filter there, copied once

    def _filter(self, name: str, x: torch.Tensor) -> torch.Tensor:
        f = getattr(self, name)
        if torch.compiler.is_compiling():  # tracing (torch.export): keep the copy out of the cache
            return f.to(device=x.device, dtype=x.dtype)
        key = (name, x.device, x.dtype)
        if key not in self._on:
            self._on[key] = f.to(device=x.device, dtype=x.dtype)
        return self._on[key]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.analysis(x)

    def analysis(self, x: torch.Tensor, channels_last: bool = False) -> torch.Tensor:
        """Runs in x's dtype with autocast off, as the JAX function runs in x's
        dtype whatever the towers' precision."""
        with torch.autocast(device_type=x.device.type, enabled=False):
            z = F.conv1d(x, self._filter("H", x), stride=self.n_bands, padding=self.taps // 2)
        return z.transpose(1, 2) if channels_last else z

    def synthesis(self, x: torch.Tensor) -> torch.Tensor:
        """[B, n_bands, T'] -> [B, 1, T' * n_bands], in x's dtype with autocast off."""
        if x.dim() != 3 or x.shape[1] != self.n_bands:
            raise ValueError(f"expected [B, {self.n_bands}, T'], got {tuple(x.shape)}")
        with torch.autocast(device_type=x.device.type, enabled=False):
            up = F.conv_transpose1d(x, self._filter("U", x), stride=self.n_bands)
            return F.conv1d(up, self._filter("G", x), padding=self.taps // 2)
