"""STFT, mel spectrogram and the multi-resolution STFT loss and its two terms, in torch.

Counterpart of the JAX package's ``ops/stft.py`` (torchaudio semantics: periodic
Hann window, center=True with reflect padding, power spectrogram, HTK mel scale
with Slaney area normalization). The transform itself is ``torch.stft`` in
float32 for every ``method`` the config names: the JAX package computes its STFT
outside any TPU kernel too, so here a library call takes its place. The JAX
``matmul_bf16``/``conv_bf16`` methods round the DFT operands to bf16 (~2e-3
relative) and ``matmul_f32`` splits them hi/lo (~1e-6); that rounding is not
reproduced: every method here computes what the JAX ``fft`` method computes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

METHODS = ("fft", "matmul_bf16", "matmul_f32", "conv_bf16")
MRSTFT_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window's default), float32."""
    n = torch.arange(win_length, dtype=torch.float32, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * np.pi * n / win_length))


def stft(
    x: torch.Tensor,
    n_fft: int = 1024,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    center: bool = True,
    pad_mode: str = "reflect",
) -> torch.Tensor:
    """Complex STFT of [..., T] -> [..., n_freq, n_frames] (torch layout). A
    window shorter than n_fft is zero-padded to it, centered."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    window = hann_window(win_length, x.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = torch.nn.functional.pad(window, (lpad, n_fft - win_length - lpad))
    lead = x.shape[:-1]
    spec = torch.stft(
        x.float().reshape(-1, x.shape[-1]), n_fft, hop_length=hop_length, win_length=n_fft,
        window=window, center=center, pad_mode=pad_mode, normalized=False, onesided=True,
        return_complex=True,
    )
    return spec.reshape(*lead, *spec.shape[-2:])


def spectrogram(x: torch.Tensor, power: float = 2.0, **stft_kwargs) -> torch.Tensor:
    """|STFT|^power. The power-2 spectrogram is re^2 + im^2, which is smooth where
    the magnitude is 0."""
    spec = stft(x, **stft_kwargs)
    if power == 2.0:
        ri = torch.view_as_real(spec)
        return ri[..., 0] * ri[..., 0] + ri[..., 1] * ri[..., 1]
    mag = spec.abs()
    return mag if power == 1.0 else mag.pow(power)


def hz_to_mel(f, mel_scale: str = "htk"):
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)
    f = np.asarray(f, dtype=np.float64)
    mel = 3.0 * f / 200.0
    log_region = f >= 1000.0
    return np.where(
        log_region, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0), mel
    )


def mel_to_hz(m, mel_scale: str = "htk"):
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)
    m = np.asarray(m, dtype=np.float64)
    f = 200.0 * m / 3.0
    log_region = m >= 15.0
    return np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)


def mel_filterbank(
    n_freqs: int,
    n_mels: int,
    sample_rate: int,
    f_min: float = 0.0,
    f_max: Optional[float] = None,
    norm: Optional[str] = "slaney",
    mel_scale: str = "htk",
) -> np.ndarray:
    """Triangular mel filterbank [n_freqs, n_mels] (torchaudio's melscale_fbanks),
    built in numpy exactly as the JAX package builds it."""
    f_max = f_max or sample_rate / 2.0
    freqs = np.linspace(0, sample_rate // 2, n_freqs)
    mel_pts = np.linspace(hz_to_mel(f_min, mel_scale), hz_to_mel(f_max, mel_scale), n_mels + 2)
    f_pts = mel_to_hz(mel_pts, mel_scale)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        fb *= (2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


class MelSpectrogram:
    """torchaudio-MelSpectrogram-shaped callable: [..., T] -> [..., n_mels, n_frames]."""

    def __init__(
        self,
        sample_rate: int = 44100,
        n_fft: int = 1024,
        win_length: Optional[int] = None,
        hop_length: int = 512,
        center: bool = True,
        pad_mode: str = "reflect",
        power: float = 2.0,
        norm: Optional[str] = "slaney",
        n_mels: int = 128,
        mel_scale: str = "htk",
        f_min: float = 0.0,
        f_max: Optional[float] = None,
        method: str = "fft",
    ):
        if method not in METHODS:
            raise ValueError(f"mel method must be one of {METHODS}, got {method!r}")
        self.method = method
        self.n_fft = n_fft
        self.win_length = win_length or n_fft
        self.hop_length = hop_length
        self.center = center
        self.pad_mode = pad_mode
        self.power = power
        self.fb = torch.from_numpy(
            mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, f_min, f_max, norm, mel_scale)
        )

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        spec = spectrogram(
            x, power=self.power, n_fft=self.n_fft, hop_length=self.hop_length,
            win_length=self.win_length, center=self.center, pad_mode=self.pad_mode,
        )  # [..., n_freq, n_frames]
        if self.fb.device != spec.device:
            self.fb = self.fb.to(spec.device)
        return torch.matmul(spec.transpose(-1, -2), self.fb).transpose(-1, -2)


def _log_magnitude(m: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp_min(m, 1e-7))


def spectral_convergence_loss(mag_pred: torch.Tensor, mag_true: torch.Tensor) -> torch.Tensor:
    """||Mt - Mp||_F / (||Mt||_F + 1e-8)."""
    num = torch.sqrt(torch.sum((mag_true - mag_pred) ** 2))
    return num / (torch.sqrt(torch.sum(mag_true**2)) + 1e-8)


def log_stft_magnitude_loss(mag_pred: torch.Tensor, mag_true: torch.Tensor) -> torch.Tensor:
    """Mean |log Mt - log Mp|, each magnitude floored at 1e-7."""
    return torch.mean(torch.abs(_log_magnitude(mag_true) - _log_magnitude(mag_pred)))


def _stft_n_frames(t: int, n_fft: int, hop: int, center: bool = True) -> int:
    """Frame count of the centered STFT (T + 2 * (n_fft // 2) padded)."""
    if center:
        t = t + 2 * (n_fft // 2)
    return 1 + (t - n_fft) // hop


def mrstft_stats(
    pred: torch.Tensor,
    true: torch.Tensor,
    resolutions: Sequence[Tuple[int, int, int]] = MRSTFT_RESOLUTIONS,
    method: str = "fft",
    batch_chunk: int = 256,
) -> torch.Tensor:
    """The MR-STFT loss's sufficient statistics [n_res, 4] of a batch of pairs:
    per resolution sum (Mt-Mp)^2, sum Mt^2, sum |log Mt - log Mp| and sum |log Mt
    - log 1e-7|, from which ``mrstft_from_stats`` rebuilds
    ``spectral_convergence_loss`` and ``log_stft_magnitude_loss`` of the whole
    batch. Sums over rows: batches add them. Batches larger than
    ``batch_chunk`` pairs run in chunks; the last chunk is zero-padded, and padded
    rows add exactly zero."""
    if method not in METHODS:
        raise ValueError(f"STFT method must be one of {METHODS}, got {method!r}")
    pred2 = pred.reshape(-1, pred.shape[-1]).float()
    true2 = true.reshape(-1, true.shape[-1]).float()
    b = pred2.shape[0]
    log_floor = float(np.log(np.float32(1e-7)))

    def chunk_stats(pair: torch.Tensor) -> torch.Tensor:  # [2, bc, T] -> [n_res, 4]
        rows = []
        for n_fft, hop, win in resolutions:
            m = stft(pair, n_fft=n_fft, hop_length=hop, win_length=win).abs()
            mp, mt = m[0], m[1]
            log_mt = _log_magnitude(mt)
            rows.append(torch.stack([
                torch.sum((mt - mp) ** 2),
                torch.sum(mt**2),
                torch.sum(torch.abs(log_mt - _log_magnitude(mp))),
                torch.sum(torch.abs(log_mt - log_floor)),
            ]))
        return torch.stack(rows)

    if b <= batch_chunk:
        return chunk_stats(torch.stack([pred2, true2]))
    n_chunks = -(-b // batch_chunk)
    pad = n_chunks * batch_chunk - b
    if pad:
        pred2 = torch.nn.functional.pad(pred2, (0, 0, 0, pad))
        true2 = torch.nn.functional.pad(true2, (0, 0, 0, pad))
    stats = None
    for c in range(n_chunks):
        rows = slice(c * batch_chunk, (c + 1) * batch_chunk)
        s = chunk_stats(torch.stack([pred2[rows], true2[rows]]))
        stats = s if stats is None else stats + s
    return stats


def mrstft_from_stats(
    stats: torch.Tensor,
    batch: int,
    audio_len: int,
    resolutions: Sequence[Tuple[int, int, int]] = MRSTFT_RESOLUTIONS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, silence baseline) from ``mrstft_stats`` of ``batch`` pairs of
    ``audio_len`` samples: the mean over resolutions of spectral convergence +
    log-magnitude L1, and the same for predicting silence (spectral convergence
    1, log-magnitudes at the 1e-7 floor)."""
    total, silence_total = 0.0, 0.0
    for i, (n_fft, hop, _) in enumerate(resolutions):
        ssd, sst, sld, sld0 = stats[i].unbind()
        n_elems = batch * (n_fft // 2 + 1) * _stft_n_frames(audio_len, n_fft, hop)
        total = total + torch.sqrt(ssd) / (torch.sqrt(sst) + 1e-8) + sld / n_elems
        silence_total = silence_total + 1.0 + sld0 / n_elems
    return total / len(resolutions), silence_total / len(resolutions)


def multi_resolution_stft_loss(
    pred: torch.Tensor,
    true: torch.Tensor,
    resolutions: Sequence[Tuple[int, int, int]] = MRSTFT_RESOLUTIONS,
    method: str = "fft",
    batch_chunk: int = 256,
    return_silence_baseline: bool = False,
):
    """auraloss-style MR-STFT loss: mean over resolutions (n_fft, hop, win) of
    spectral convergence + log-magnitude L1, from ``mrstft_stats`` (which see
    for ``batch_chunk``). ``return_silence_baseline`` also returns the loss of
    predicting silence, computed from the true magnitudes alone."""
    stats = mrstft_stats(pred, true, resolutions, method, batch_chunk)
    b = pred.reshape(-1, pred.shape[-1]).shape[0]
    loss, silence = mrstft_from_stats(stats, b, pred.shape[-1], resolutions)
    if return_silence_baseline:
        return loss, silence
    return loss


def mel_l1_loss(mel: MelSpectrogram, pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    """Mean |mel(pred) - mel(true)|; pred and true go through one stacked mel call."""
    m = mel(torch.stack([pred, true]))
    return torch.mean(torch.abs(m[0] - m[1]))
