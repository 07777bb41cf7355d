"""Mel spectrogram in float32 (torchaudio's semantics): periodic Hann window,
centred frames with reflect padding, power spectrogram, HTK mel scale with
Slaney area normalisation; the filterbank built in numpy."""

from __future__ import annotations

import numpy as np
import torch


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int, norm: str = "slaney") -> np.ndarray:
    freqs = np.linspace(0, sample_rate // 2, n_freqs)
    f_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2.0), n_mels + 2))
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / f_diff[:-1], slopes[:, 2:] / f_diff[1:]))
    if norm == "slaney":
        fb *= (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


class MelSpectrogram:
    def __init__(self, sample_rate, n_fft, hop_length, n_mels, norm, mel_scale, power, device):
        if mel_scale != "htk" or power != 2.0:
            raise ValueError("the reference mel spectrogram takes the htk scale and power 2")
        self.n_fft, self.hop = n_fft, hop_length
        n = torch.arange(n_fft, dtype=torch.float32, device=device)
        self.window = 0.5 * (1.0 - torch.cos(2.0 * np.pi * n / n_fft))
        self.fb = torch.from_numpy(mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, norm)).to(device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:  # [..., T] -> [..., n_mels, frames]
        lead = x.shape[:-1]
        spec = torch.stft(x.float().reshape(-1, x.shape[-1]), self.n_fft, hop_length=self.hop,
                          win_length=self.n_fft, window=self.window, center=True, pad_mode="reflect",
                          normalized=False, onesided=True, return_complex=True)
        ri = torch.view_as_real(spec)
        power = ri[..., 0] * ri[..., 0] + ri[..., 1] * ri[..., 1]
        mel = torch.matmul(power.transpose(-1, -2), self.fb).transpose(-1, -2)
        return mel.reshape(*lead, *mel.shape[-2:])
