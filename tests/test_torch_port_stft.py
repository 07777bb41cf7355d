"""The port's spectral stack (ops/stft.py) against the JAX package's ``fft`` path.

Inputs are numpy draws handed to both packages. The port's transform is
torch.stft in float32 and the JAX one jnp.fft.rfft in float32: both exact
transforms, so they agree to float32 rounding. Tolerances are relative to the
reference's scale, stated per test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverse_audio_synthesis_tpu.ops import stft as jstft
from inverse_audio_synthesis_tpu_torch.ops import stft as tstft

torch.set_num_threads(2)


def _audio(shape, seed):
    return np.random.RandomState(seed).uniform(-1.0, 1.0, shape).astype(np.float32)


@pytest.mark.parametrize("mel_scale,norm", [("htk", "slaney"), ("slaney", None), ("htk", None)])
def test_mel_filterbank_equal(mel_scale, norm):
    ref = jstft.mel_filterbank(513, 128, 44100, norm=norm, mel_scale=mel_scale)
    np.testing.assert_array_equal(tstft.mel_filterbank(513, 128, 44100, norm=norm, mel_scale=mel_scale), ref)


@pytest.mark.parametrize("n_fft,hop,win", [(1024, 512, None), (1024, 120, 600), (512, 50, 240)])
def test_stft_matches_jax(n_fft, hop, win):
    """Complex STFT, centered with reflect padding; a window shorter than n_fft
    is zero-padded to it. Measured max |d| 1.4e-7 to 1.7e-7 of the largest
    magnitude, held at 1e-5."""
    x = _audio((2, 3, 6000), 0)
    ref = np.asarray(jstft.stft(jnp.asarray(x), n_fft=n_fft, hop_length=hop, win_length=win))
    got = tstft.stft(torch.from_numpy(x), n_fft=n_fft, hop_length=hop, win_length=win).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("method", ["fft", "matmul_bf16", "matmul_f32", "conv_bf16"])
def test_mel_spectrogram_matches_jax_fft(method):
    """Every method is the float32 transform; held against JAX's exact ``fft``
    method at 1e-5 of the largest mel value (measured 2.9e-7)."""
    x = _audio((4, 14400), 1)
    ref = np.asarray(jstft.MelSpectrogram(sample_rate=44100, method="fft")(jnp.asarray(x)))
    got = tstft.MelSpectrogram(sample_rate=44100, method=method)(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (4, 128, 29)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_mel_l1_loss_matches_jax():
    """Measured relative 1.1e-7, held at 1e-5."""
    pred, true = _audio((3, 12000), 2), _audio((3, 12000), 3)
    ref = float(jstft.mel_l1_loss(jstft.MelSpectrogram(method="fft"), jnp.asarray(pred), jnp.asarray(true)))
    got = float(tstft.mel_l1_loss(tstft.MelSpectrogram(), torch.from_numpy(pred), torch.from_numpy(true)))
    assert got == pytest.approx(ref, rel=1e-5)


@pytest.mark.parametrize("batch_chunk", [256, 3])
def test_mrstft_with_chunks_and_silence_baseline(batch_chunk):
    """Five pairs: in one chunk, and in chunks of 3 with a zero-padded tail. The
    loss and the analytic silence baseline against the JAX fft path (whose own
    batch_chunk is left at 256): measured relative 7.8e-8 (loss) and 1.0e-7
    (baseline), held at 1e-5."""
    rng = np.random.RandomState(4)
    true = _audio((5, 9000), 5)
    pred = (true + 0.3 * rng.randn(5, 9000)).astype(np.float32)
    ref, ref_sil = jstft.multi_resolution_stft_loss(
        jnp.asarray(pred), jnp.asarray(true), method="fft", return_silence_baseline=True
    )
    got, got_sil = tstft.multi_resolution_stft_loss(
        torch.from_numpy(pred), torch.from_numpy(true), method="matmul_bf16",
        batch_chunk=batch_chunk, return_silence_baseline=True,
    )
    assert float(got) == pytest.approx(float(ref), rel=1e-5)
    assert float(got_sil) == pytest.approx(float(ref_sil), rel=1e-5)
    assert float(tstft.multi_resolution_stft_loss(torch.from_numpy(true), torch.from_numpy(true))) == pytest.approx(
        0.0, abs=1e-6
    )


def test_n_frames_and_method_refusal():
    for t, n_fft, hop in ((176400, 1024, 512), (14400, 2048, 240), (6000, 512, 50)):
        assert tstft._stft_n_frames(t, n_fft, hop) == jstft._stft_n_frames(t, n_fft, hop)
        assert tstft.stft(torch.zeros(1, t), n_fft=n_fft, hop_length=hop).shape[-1] == tstft._stft_n_frames(
            t, n_fft, hop
        )
    with pytest.raises(ValueError):
        tstft.MelSpectrogram(method="dft")
    with pytest.raises(ValueError):
        tstft.multi_resolution_stft_loss(torch.zeros(1, 4096), torch.zeros(1, 4096), method="dft")


def test_mel_gradient_is_finite_at_silence():
    """The power spectrogram is re^2 + im^2: its gradient stays finite where a
    frame is silent (the mel term backpropagates through rendered silence)."""
    x = torch.zeros(2, 6000)
    x[0, 3000:] = torch.from_numpy(_audio((3000,), 6))
    x.requires_grad_()
    (g,) = torch.autograd.grad(tstft.MelSpectrogram()(x).sum(), x)
    assert torch.isfinite(g).all()
