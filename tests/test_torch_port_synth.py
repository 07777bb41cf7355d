"""The PyTorch port's synth against the JAX package: RNG, math, controls, render.

The RNG and the float32 math must be bit-identical (same batch number -> same
voices and noise in both packages). The control-rate graph and the portable render
use builtin cos/pow/cumsum, whose last bits differ between XLA and torch, so they
are held to stated tolerances.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverse_audio_synthesis_tpu.ops import math_ops as jmath
from inverse_audio_synthesis_tpu.ops import scan_ops as jscan
from inverse_audio_synthesis_tpu.synth import SynthConfig as JSynthConfig
from inverse_audio_synthesis_tpu.synth import modules as jmodules
from inverse_audio_synthesis_tpu.synth import parameter as jparameter
from inverse_audio_synthesis_tpu.synth import voice as jvoice
from inverse_audio_synthesis_tpu_torch.ops import math_ops as tmath
from inverse_audio_synthesis_tpu_torch.ops import scan_ops as tscan
from inverse_audio_synthesis_tpu_torch.synth import SynthConfig, prng
from inverse_audio_synthesis_tpu_torch.synth import parameter as tparameter
from inverse_audio_synthesis_tpu_torch.synth import voice as tvoice

torch.set_num_threads(2)

TINY_SECONDS = 3 * 64 * 64 / 44100  # tests/conftest.py tiny config: non-integer ratio
GEOMETRIES = {"tiny": TINY_SECONDS, "1s": 1.0}


def _rel_rms(ref, x):
    return float(np.sqrt(np.mean((ref - x) ** 2)) / (np.sqrt(np.mean(ref**2)) + 1e-12))


# -- RNG: bit-identical --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 13, 42, 2**31 - 1])
def test_prng_key_and_fold_in_bit_identical(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(key), prng.prng_key(seed).numpy())
    for data in (0, 1, 7, 123456, 2**32 - 1):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(key, data)),
            prng.fold_in(prng.prng_key(seed), data).numpy(),
        )


@pytest.mark.parametrize("shape", [(1,), (7,), (16, 78), (3, 5, 11)])
def test_uniform_bit_identical(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(5), 99)
    tkey = prng.fold_in(prng.prng_key(5), 99)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(key, shape)), prng.uniform(tkey, shape).numpy()
    )
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(key, shape, minval=-1.0, maxval=1.0)),
        prng.uniform(tkey, shape, -1.0, 1.0).numpy(),
    )


@pytest.mark.parametrize("batch_num", [0, 1, 1234, 49_999_999])
def test_sample_voice_params_bit_identical(batch_num):
    jcfg = JSynthConfig(batch_size=16, seed=42)
    cfg = SynthConfig(batch_size=16, seed=42)
    np.testing.assert_array_equal(
        np.asarray(jvoice.sample_voice_params(batch_num, jcfg)),
        tvoice.sample_voice_params(batch_num, cfg).numpy(),
    )


@pytest.mark.parametrize("n_samples", [4410, 4411])
def test_noise_bit_identical(n_samples):
    j = jmodules.noise(jax.random.PRNGKey(13), 3, n_samples)
    t = tvoice.modules.noise(prng.prng_key(13), 3, n_samples)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    # rows are position-keyed: the buffer of a larger batch starts with this one
    cfg = SynthConfig(batch_size=4, buffer_size_seconds=0.1)
    np.testing.assert_array_equal(
        tvoice.make_noise(cfg, batch_size=2).numpy(), tvoice.make_noise(cfg).numpy()[:2]
    )


def test_is_train_split():
    cfg = SynthConfig(batch_size=4)
    for n in (0, 3, 10, 11):
        np.testing.assert_array_equal(
            tvoice.is_train_split(n, cfg).numpy(),
            np.asarray(jvoice.is_train_split(n, JSynthConfig(batch_size=4))),
        )


# -- float32 math: bit-identical ---------------------------------------------------


@pytest.mark.parametrize(
    "name,lo,hi",
    [
        ("exp2_accurate", -120.0, 120.0),
        ("cos_fast", -4096.0, 4096.0),
        ("tanh_fast", -60.0, 60.0),
    ],
)
def test_math_ops_bit_identical(name, lo, hi):
    x = np.linspace(lo, hi, 1_000_003, dtype=np.float32)
    x = np.concatenate([x, np.float32([0.0, -0.0, 0.5, -0.5, 1e-30, 126.9])])
    ref = np.asarray(getattr(jmath, name)(jnp.asarray(x)))
    got = getattr(tmath, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ref, got)


def test_sincos_fast_bit_identical():
    x = np.linspace(-400.0, 400.0, 1_000_001, dtype=np.float32)
    js, jc = jmath.sincos_fast(jnp.asarray(x))
    ts, tc = tmath.sincos_fast(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())


def test_fmod_floor_matches_jnp_mod():
    x = np.random.RandomState(0).randn(100_000).astype(np.float32) * 300.0
    x[:4] = [-1.0, 0.0, -2 * np.pi, 4 * np.pi]
    two_pi = 2.0 * math.pi
    np.testing.assert_array_equal(
        np.asarray(jnp.mod(jnp.asarray(x), two_pi)),
        tscan.fmod_floor(torch.from_numpy(x), two_pi).numpy(),
    )


# -- parameters and the control-rate graph (tolerances) ----------------------------


def test_param_specs_and_from_0to1():
    assert len(tvoice.VOICE_PARAM_SPECS) == 78
    x = np.random.RandomState(1).rand(64).astype(np.float32)
    x[:2] = [0.0, 0.5]
    for js, ts in zip(jvoice.VOICE_PARAM_SPECS, tvoice.VOICE_PARAM_SPECS):
        assert (js.module, js.name, js.minimum, js.maximum, js.curve, js.symmetric) == (
            ts.module, ts.name, ts.minimum, ts.maximum, ts.curve, ts.symmetric
        )
        ref = np.asarray(jparameter.from_0to1(js, jnp.asarray(x)))
        got = tparameter.from_0to1(ts, torch.from_numpy(x)).numpy()
        # float32 pow: XLA's and torch's powf may differ in the last ulp
        np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-6 * max(1.0, ts.maximum))


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_compute_controls_and_scalars(geometry):
    secs = GEOMETRIES[geometry]
    jcfg = JSynthConfig(batch_size=4, buffer_size_seconds=secs)
    cfg = SynthConfig(batch_size=4, buffer_size_seconds=secs)
    p = jvoice.sample_voice_params(42, jcfg)
    jp, jrouted, jmidi = jvoice.compute_controls(p, jcfg)
    tp, trouted, tmidi = tvoice.compute_controls(torch.from_numpy(np.array(p)), cfg)
    # routed controls are O(1); the LFOs go through builtin cos and a cumsum whose
    # roundings differ between XLA and torch: measured ~3e-6 at 1 s
    np.testing.assert_allclose(trouted.numpy(), np.asarray(jrouted), rtol=0, atol=2e-5)
    scal = np.asarray(jvoice._fused_scalars(jp, jmidi))
    np.testing.assert_allclose(tvoice.fused_scalars(tp, tmidi).numpy(), scal, rtol=1e-5, atol=1e-6)


def test_scan_ops_match_jax():
    rng = np.random.RandomState(3)
    dphi = (rng.rand(2, 20_000) * 1.7).astype(np.float32)
    ref = np.asarray(jscan.phase_cumsum(jnp.asarray(dphi)))
    got = tscan.phase_cumsum(torch.from_numpy(dphi)).numpy()
    # within-chunk prefix: XLA's float32 dot vs torch.cumsum, then wrapped chunk
    # offsets; phases reach ~220 rad (ulp 1.5e-5). Measured max 3.5e-4
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    ctl = rng.rand(3, 441).astype(np.float32)
    for n_out in (44_100, 12_288):  # integer and non-integer ratios
        np.testing.assert_allclose(
            tscan.linear_upsample(torch.from_numpy(ctl), n_out).numpy(),
            np.asarray(jscan.linear_upsample(jnp.asarray(ctl), n_out)),
            rtol=0, atol=1e-6,
        )


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_render_voice_matches_jax(geometry):
    """The portable render against the JAX one, through the same batch number.

    Same algorithm; the phase of a voice integrates its routed pitch control over
    the whole buffer, so the ~1e-6 control differences above grow into waveform
    jitter. Measured at 1 s: max 0.023, rel-rms 0.0068; held to the repo's render
    bound (tests/test_pallas_render.py)."""
    secs = GEOMETRIES[geometry]
    jcfg = JSynthConfig(batch_size=4, buffer_size_seconds=secs)
    cfg = SynthConfig(batch_size=4, buffer_size_seconds=secs)
    ref = np.asarray(jvoice.render_voice(jvoice.sample_voice_params(42, jcfg), jcfg))
    got = tvoice.render_voice(tvoice.sample_voice_params(42, cfg), cfg).numpy()
    assert got.shape == ref.shape == (4, cfg.buffer_size)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() < 0.08
    assert _rel_rms(ref, got) < 0.01


# -- gradients at exact ties: split as JAX splits them ---------------------------------


def _attack_tie_params(batch: int = 4):
    """params01 whose adsr_1 attack, in control steps, is an integer k exactly in
    both packages: the attack ramp (t - 0) / (attack * rate) reaches 1.0 exactly at
    t = k, a tie of the clip's upper bound, and the decay ramp starts exactly at 0
    there, a tie of its lower bound. Both feed the attack's gradient."""
    specs = [(s.module, s.name) for s in tvoice.VOICE_PARAM_SPECS]
    i_att, i_dur = specs.index(("adsr_1", "attack")), specs.index(("keyboard", "duration"))
    spec = tvoice.VOICE_PARAM_SPECS[i_att]
    jspec = jvoice.VOICE_PARAM_SPECS[i_att]
    for k in range(37, 300):
        s = np.float32(np.float32(k) / np.float32(441.0)) / np.float32(2.0)
        for x in (np.float32(s * s) + np.float32(d) * np.spacing(np.float32(s * s)) for d in (0, 1, -1, 2, -2)):
            xa = np.array([x], np.float32)
            a_t = tparameter.from_0to1(spec, torch.from_numpy(xa))
            a_j = np.asarray(jparameter.from_0to1(jspec, jnp.asarray(xa)))
            if (a_t * 441.0).item() == k and float(np.float32(a_j[0] * np.float32(441.0))) == k:
                p = np.random.RandomState(k).rand(batch, 78).astype(np.float32)
                p[:, i_att] = x
                p[:, i_dur] = 0.95  # note held well past the attack
                return p, k
    raise AssertionError("no exact attack tie found")


def test_compute_controls_grad_splits_ties_as_jax():
    """Exact ties in the ADSR clips: jnp.clip passes half the gradient to each side
    at a tie; torch.clamp passed all of it, which made the attack's gradient differ.
    The port now spells clip and max as minimum/maximum against tensors. The
    gradient of sum(routed * cot) with respect to params01, against jax.grad:
    measured max-relative 2e-6 without ties, held at 1e-4; a tie spelled as clamp
    moves the attack column by about 1/k (k ~ 40 control steps)."""
    p, k = _attack_tie_params()
    cfg = SynthConfig(batch_size=4, buffer_size_seconds=1.0)
    jcfg = JSynthConfig(batch_size=4, buffer_size_seconds=1.0)
    cot = np.random.RandomState(1).randn(4, 5, cfg.control_buffer_size).astype(np.float32)

    def jloss(q):
        return jnp.sum(jvoice.compute_controls(q, jcfg)[1] * jnp.asarray(cot))

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(p)))
    q = torch.from_numpy(p).requires_grad_()
    (got,) = torch.autograd.grad((tvoice.compute_controls(q, cfg)[1] * torch.from_numpy(cot)).sum(), q)
    got = got.numpy()
    # forward values stay bit-compatible with the clamp spelling
    _, routed, _ = tvoice.compute_controls(torch.from_numpy(p), cfg)
    np.testing.assert_allclose(routed.numpy(), np.asarray(jvoice.compute_controls(jnp.asarray(p), jcfg)[1]),
                               rtol=0, atol=2e-5)
    assert np.isfinite(got).all() and k > 0
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-4
    i_att = [(s.module, s.name) for s in tvoice.VOICE_PARAM_SPECS].index(("adsr_1", "attack"))
    col = np.abs(got[:, i_att] - ref[:, i_att]).max() / np.abs(ref[:, i_att]).max()
    assert col <= 1e-4, col


def test_maximum_and_clip_split_ties():
    from inverse_audio_synthesis_tpu_torch.synth import modules as tmodules

    x = torch.tensor([0.0, 1.0, -1.0, 2.0], requires_grad=True)
    (gm,) = torch.autograd.grad(tmodules.maximum(x, 0.0).sum(), x)
    (gc,) = torch.autograd.grad(tmodules.clip(x, 0.0, 1.0).sum(), x)
    jx = jnp.array([0.0, 1.0, -1.0, 2.0])
    np.testing.assert_array_equal(gm.numpy(), np.asarray(jax.grad(lambda v: jnp.maximum(v, 0.0).sum())(jx)))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(jx)))
    np.testing.assert_array_equal(tmodules.clip(x, 0.0, 1.0).detach().numpy(),
                                  torch.clamp(x, 0.0, 1.0).detach().numpy())
