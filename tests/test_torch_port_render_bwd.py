"""The port's render backward (K2, ops/render.py) against the JAX package.

On the CPU the render's autograd Function runs the plain versions of both
kernels, so these tests hold the backward's plain version against the JAX
backward kernel (``render_audio_fused_bwd`` in interpret mode), against autograd
of the port's plain forward, and the params01 gradient of ``render_voice_fused``
against ``jax.vjp`` of the JAX one. Inputs come from numpy seeds and the shared
batch-number draw (bit-identical in both packages). The CUDA kernel runs only on
the card: the tests marked ``cuda`` hold it against the plain version there:

    python -m pytest --noconftest -m cuda tests/test_torch_port_render_bwd.py

Tolerances: d_routed within 5e-4 and d_scalars within 1e-4 of the largest
|reference| of each signal row and scalar column, the JAX package's bounds for
its backward (tests/test_pallas_render.py:297-298), held per row here because the
pitch rows dominate a global maximum. Against the JAX kernel, whose forward phase
rounds differently, d_scalars is held per column at 2e-3; the JAX package's own
two evaluations of that function depart from each other by as much (see those
tests).
"""

import numpy as np
import pytest
import torch

from inverse_audio_synthesis_tpu_torch.ops import launches
from inverse_audio_synthesis_tpu_torch.ops import render as R
from inverse_audio_synthesis_tpu_torch.synth import SynthConfig
from inverse_audio_synthesis_tpu_torch.synth import voice as tvoice

torch.set_num_threads(2)

SINGLE_TILE = 63 / 441  # Tc 63: one tile of the JAX kernel (64 segments at ratio 100)
BOUND = {"d_routed": 5e-4, "d_scalars": 1e-4}


def _inputs(batch: int, secs: float, batch_num: int, device="cpu"):
    cfg = SynthConfig(batch_size=batch, buffer_size_seconds=secs)
    params01 = tvoice.sample_voice_params(batch_num, cfg, device)
    p, routed, midi_f0 = tvoice.compute_controls(params01, cfg)
    scalars = tvoice.fused_scalars(p, midi_f0)
    return cfg, params01, routed.contiguous(), scalars.contiguous(), tvoice.make_noise(cfg, device)


def _cotangent(shape, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))


def _plain_bwd(routed, scalars, noise, g):
    _, seg_mean, offset = R.render_audio_plain(routed, scalars, noise, 44100.0, save_phase=True)
    return R.render_audio_bwd_plain(routed, scalars, noise, g, seg_mean, offset, 44100.0)


def _per_row_rel(got, ref, axis_rows):
    """max |got - ref| / max |ref| for each row index along ``axis_rows``."""
    got, ref = np.moveaxis(np.asarray(got), axis_rows, 0), np.moveaxis(np.asarray(ref), axis_rows, 0)
    return np.array([
        np.abs(g - r).max() / (np.abs(r).max() + 1e-30) for g, r in zip(got, ref)
    ])


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _jax_bwd(routed, scalars, noise, g):
    import jax.numpy as jnp

    from inverse_audio_synthesis_tpu.ops.pallas import render as JR

    args = [jnp.asarray(t.numpy()) for t in (routed, scalars, noise)]
    _, carries = JR.render_audio_fused(*args, 44100.0, interpret=True, save_carries=True)
    dr, ds = JR.render_audio_fused_bwd(*args, jnp.asarray(g.numpy()), carries, 44100.0, interpret=True)
    return np.asarray(dr), np.asarray(ds)


@pytest.mark.parametrize("batch_num", [42, 7])
def test_plain_bwd_matches_jax_kernel_on_one_tile(batch_num):
    """One tile of the JAX kernel (two of the port's, with one wrapped carry
    between them), and the two forwards' phases differ only
    by the rounding of their prefix sums (JAX: mean plus split-matmul residual
    prefix; port: lane runs, butterflies and scans), about 1e-5 rad. d_routed per
    signal: measured max 1.6e-4 / 2.6e-4 (batch numbers 42 / 7), held at 5e-4. The
    scalar cotangents are sums over all samples of terms of random sign (the
    cotangent is noise), so they cancel and magnify that phase rounding: measured
    per column up to 1.29e-3 / 4.9e-4 (the largest on the partials column), held per
    column at 2e-3. The next test shows the JAX package's own two evaluations of
    this function departing from each other by as much. Against autograd of its
    own forward the plain backward holds 1e-4 per column (the test after)."""
    _, _, routed, scalars, noise = _inputs(4, SINGLE_TILE, batch_num)
    g = _cotangent(noise.shape, batch_num)
    dr, ds = _plain_bwd(routed, scalars, noise, g)
    jdr, jds = _jax_bwd(routed, scalars, noise, g)
    assert dr.shape == (4, 5, 63) and ds.shape == (4, 16)
    assert (_per_row_rel(dr, jdr, 1) <= BOUND["d_routed"]).all()
    assert (_per_row_rel(ds[:, :11], jds[:, :11], 1) <= 2e-3).all()
    np.testing.assert_array_equal(ds[:, 11:].numpy(), 0.0)


@pytest.mark.parametrize("batch_num", [42, 7])
def test_jax_kernel_departs_from_its_own_replica_as_far(batch_num):
    """The cause of the per-column gap above, within the JAX package alone: its
    backward kernel against jax.vjp of its own pure-jnp replica of the forward
    (tests/test_pallas_render.py:_kernel_replica, the oracle of its backward),
    evaluated op by op so that XLA does not refold the phase prefix. The same
    function, rounded another way, departs per column by up to 1.11e-3 / 9.2e-4
    (batch numbers 42 / 7; jitted, as the JAX test runs it, 1.3e-6 / 5.7e-5):
    as far as the port does (1.29e-3 / 4.9e-4). Held: the JAX package's own gap
    exceeds the 1e-4 per column asked of the port, and the port's gap stays
    within twice it."""
    import jax
    import jax.numpy as jnp
    from test_pallas_render import _kernel_replica

    _, _, routed, scalars, noise = _inputs(4, SINGLE_TILE, batch_num)
    g = _cotangent(noise.shape, batch_num)
    _, ds = _plain_bwd(routed, scalars, noise, g)
    _, jds = _jax_bwd(routed, scalars, noise, g)
    nz = jnp.asarray(noise.numpy())
    _, vjp = jax.vjp(lambda r_, s_: _kernel_replica(r_, s_, nz, 44100.0),
                     jnp.asarray(routed.numpy()), jnp.asarray(scalars.numpy()))
    _, rds = vjp(jnp.asarray(g.numpy()))
    jax_gap = _per_row_rel(jds[:, :11], np.asarray(rds)[:, :11], 1).max()
    port_gap = _per_row_rel(ds[:, :11], jds[:, :11], 1).max()
    assert jax_gap > BOUND["d_scalars"]
    assert port_gap <= 2 * jax_gap


def test_plain_bwd_follows_jax_kernel_at_1s():
    """At 1 s (7 tiles) the two forwards' phase associations differ (JAX: matmul
    prefixes; port: lane runs and warp scans), and ill-conditioned pitch directions
    amplify that, so this is directional, at the JAX repo's own bound
    (tests/test_pallas_render.py:344). Measured cosines 0.999996 / 0.999998."""
    _, _, routed, scalars, noise = _inputs(4, 1.0, 42)
    g = _cotangent(noise.shape, 0)
    dr, ds = _plain_bwd(routed, scalars, noise, g)
    jdr, jds = _jax_bwd(routed, scalars, noise, g)
    assert np.isfinite(dr.numpy()).all() and np.isfinite(ds.numpy()).all()
    assert _cos(dr, jdr) >= 0.97
    assert _cos(ds, jds) >= 0.97


@pytest.mark.parametrize("secs,batch_num", [(1.0, 42), (1.0, 1234), (130 / 441, 5)])
def test_plain_bwd_matches_autograd_of_plain_forward(secs, batch_num):
    """Against autograd of the plain forward: the same trajectory, the derivative
    chains associated differently. Entries fed by a sample exactly on a mask's
    threshold are left out: autograd of the forward's clamp passes the gradient
    there and the kernel's strict masks do not (every amplitude control is 0 at
    control step 0). 130/441 s leaves its last tile part-filled. Measured max
    per-row 4.4e-7 to 6.9e-7 (d_routed) and 5.3e-7 to 2.4e-6 (d_scalars)."""
    _, _, routed, scalars, noise = _inputs(4, secs, batch_num)
    g = _cotangent(noise.shape, batch_num)
    dr, ds = _plain_bwd(routed, scalars, noise, g)
    r_, s_ = routed.clone().requires_grad_(), scalars.clone().requires_grad_()
    dr_a, ds_a = torch.autograd.grad(R.render_audio_plain(r_, s_, noise, 44100.0), (r_, s_), g)
    tie_r, tie_s = R.gradient_ties(routed, scalars, noise.shape[-1])
    assert tie_r[:, [1, 3, 4], 0].all()  # the ties are real
    keep_r, keep_s = (~tie_r).float(), (~tie_s).float()
    assert (_per_row_rel(dr * keep_r, dr_a * keep_r, 1) <= BOUND["d_routed"]).all()
    assert (_per_row_rel((ds * keep_s)[:, :11], (ds_a * keep_s)[:, :11], 1) <= BOUND["d_scalars"]).all()


def test_batch_padding_rows_are_independent():
    """The rows of a batch of 3 are the leading rows of a batch of 8."""
    _, _, routed, scalars, noise = _inputs(8, 1.0, 7)
    g = _cotangent(noise.shape, 1)
    dr8, ds8 = _plain_bwd(routed, scalars, noise, g)
    dr3, ds3 = _plain_bwd(routed[:3], scalars[:3], noise[:3], g[:3])
    torch.testing.assert_close(dr3, dr8[:3], rtol=0, atol=1e-6)
    torch.testing.assert_close(ds3, ds8[:3], rtol=0, atol=1e-6)


def _jax_params_grad(secs: float, batch_num: int, cot: np.ndarray, bwd: str):
    import jax
    import jax.numpy as jnp

    from inverse_audio_synthesis_tpu.synth import SynthConfig as JSynthConfig
    from inverse_audio_synthesis_tpu.synth import voice as jvoice

    jcfg = JSynthConfig(batch_size=cot.shape[0], buffer_size_seconds=secs)
    p = jvoice.sample_voice_params(batch_num, jcfg)
    _, vjp = jax.vjp(lambda q: jvoice.render_voice_fused(q, jcfg, True, bwd=bwd), p)
    return np.asarray(vjp(jnp.asarray(cot))[0])


def _port_params_grad(secs: float, batch_num: int, cot: np.ndarray, bwd: str = "pallas"):
    cfg = SynthConfig(batch_size=cot.shape[0], buffer_size_seconds=secs)
    p = tvoice.sample_voice_params(batch_num, cfg).requires_grad_()
    (gp,) = torch.autograd.grad(tvoice.render_voice_fused(p, cfg, bwd=bwd), p, torch.from_numpy(cot))
    return gp.numpy()


def test_render_voice_fused_params_grad_matches_jax_on_one_tile():
    """params01 -> audio through the whole synth: the control-rate half by
    autograd (ties split as JAX's), the audio-rate half by K2's plain version,
    against jax.vjp through the JAX kernels. Measured max-relative 3.2e-4."""
    cot = np.random.RandomState(0).randn(4, 6300).astype(np.float32)
    got = _port_params_grad(SINGLE_TILE, 42, cot)
    ref = _jax_params_grad(SINGLE_TILE, 42, cot, "pallas")
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-3


def test_render_voice_fused_params_grad_follows_jax_at_1s():
    """Directional at 1 s, as the JAX repo's own check. Measured cosine 0.9999999."""
    cot = np.random.RandomState(1).randn(4, 44100).astype(np.float32)
    got = _port_params_grad(1.0, 7, cot)
    ref = _jax_params_grad(1.0, 7, cot, "pallas")
    assert np.isfinite(got).all()
    assert _cos(got, ref) >= 0.97


def test_render_bwd_jnp_is_the_gradient_of_render_voice():
    """render_bwd=jnp: the fused forward, the gradient of the portable render."""
    cfg = SynthConfig(batch_size=3, buffer_size_seconds=SINGLE_TILE)
    cot = np.random.RandomState(2).randn(3, cfg.buffer_size).astype(np.float32)
    got = _port_params_grad(SINGLE_TILE, 3, cot, bwd="jnp")
    p = tvoice.sample_voice_params(3, cfg).requires_grad_()
    (ref,) = torch.autograd.grad(tvoice.render_voice(p, cfg), p, torch.from_numpy(cot))
    np.testing.assert_array_equal(got, ref.numpy())
    with pytest.raises(ValueError, match="render_bwd"):
        tvoice.render_voice_fused(p, cfg, bwd="xla")


def test_cpu_autograd_uses_plain_versions_without_counting():
    _, _, routed, scalars, noise = _inputs(2, SINGLE_TILE, 9)
    before = dict(R.launch_counts)
    r_ = routed.clone().requires_grad_()
    out = R.render_audio_fused(r_, scalars, noise, 44100.0)
    (dr,) = torch.autograd.grad(out, r_, torch.ones_like(out))
    assert R.launch_counts == before  # only a CUDA launch counts
    torch.testing.assert_close(out, R.render_audio_plain(routed, scalars, noise, 44100.0), rtol=0, atol=0)
    ref, _ = _plain_bwd(routed, scalars, noise, torch.ones_like(out))
    torch.testing.assert_close(dr, ref, rtol=0, atol=0)


def test_assemble_d_routed_is_the_upsampling_adjoint():
    """The shift-add of the per-segment components is the adjoint of the
    (prev, left, next) gather with the edge clamps, padded segments dropped."""
    rng = np.random.RandomState(4)
    tc, tcp = 70, 128
    d_seg = torch.from_numpy(rng.randn(2, 5, 3, tcp).astype(np.float64))
    d_seg[..., tc:] = 0.0
    routed = torch.from_numpy(rng.randn(2, 5, tc)).requires_grad_()
    seg = torch.arange(tcp)
    gathered = torch.stack([
        routed[..., (seg - 1).clamp(0, tc - 1)], routed[..., seg.clamp(max=tc - 1)],
        routed[..., (seg + 1).clamp(max=tc - 1)],
    ], dim=2)
    (ref,) = torch.autograd.grad(gathered, routed, d_seg)
    torch.testing.assert_close(R.assemble_d_routed(d_seg, tc), ref)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the render backward kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4, 16])
def test_cuda_bwd_kernel_matches_plain(cuda_device, batch):
    _, _, routed, scalars, noise = _inputs(batch, 4.0, 11, cuda_device)
    g = torch.randn(noise.shape, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(0))
    _, seg_mean, offset = R.render_audio_fused(routed, scalars, noise, 44100.0, save_phase=True)
    before = R.launch_counts["render_bwd"]
    dr, ds = R.render_audio_fused_bwd(routed, scalars, noise, g, seg_mean, offset, 44100.0)
    torch.cuda.synchronize()
    assert R.launch_counts["render_bwd"] == before + 1
    dr_p, ds_p = R.render_audio_bwd_plain(routed, scalars, noise, g, seg_mean, offset, 44100.0)
    assert (_per_row_rel(dr.cpu(), dr_p.cpu(), 1) <= BOUND["d_routed"]).all()
    assert (_per_row_rel(ds.cpu()[:, :11], ds_p.cpu()[:, :11], 1) <= BOUND["d_scalars"]).all()


@pytest.mark.cuda
def test_cuda_autograd_launches_both_kernels(cuda_device):
    cfg = SynthConfig(batch_size=4, buffer_size_seconds=1.0)
    p = tvoice.sample_voice_params(5, cfg, cuda_device).requires_grad_()
    launches.reset()
    audio = tvoice.render_voice_fused(p, cfg)
    (gp,) = torch.autograd.grad(audio.pow(2).mean(), p)
    torch.cuda.synchronize()
    assert R.launch_counts == {"render_fwd": 1, "render_bwd": 1}
    assert torch.isfinite(gp).all() and float(gp.abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4, 16])
def test_cuda_bwd_kernel_repeats_bit_for_bit_and_matches_plain(cuda_device, batch):
    """One launch per call (the scalar fold runs in the voice's last block); a
    second call gives the same bits, equal to the plain version's."""
    _, _, routed, scalars, noise = _inputs(batch, 4.0, 13, cuda_device)
    g = torch.randn(noise.shape, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(1))
    _, seg_mean, offset = R.render_audio_fused(routed, scalars, noise, 44100.0, save_phase=True)
    before = R.launch_counts["render_bwd"]
    first = R.render_audio_fused_bwd(routed, scalars, noise, g, seg_mean, offset, 44100.0)
    second = R.render_audio_fused_bwd(routed, scalars, noise, g, seg_mean, offset, 44100.0)
    torch.cuda.synchronize()
    assert R.launch_counts["render_bwd"] == before + 2
    plain = R.render_audio_bwd_plain(routed, scalars, noise, g, seg_mean, offset, 44100.0)
    for a, b, c in zip(first, second, plain):
        assert torch.equal(a, b) and torch.equal(a, c)
