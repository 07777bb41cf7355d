"""The port's fused render (ops/render.py) against the JAX package's render.

On the CPU the wrapper runs the kernel's plain version, so these tests hold that
plain version against the JAX Pallas kernel (interpret mode) and the JAX portable
render on identical inputs. The CUDA kernel itself runs only on the card: the
tests marked ``cuda`` hold it against the plain version there and skip here. The
JAX package is imported inside the tests that use it, so that the card's tests
run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_render.py
"""

import os

import numpy as np
import pytest
import torch

from inverse_audio_synthesis_tpu_torch.ops import render as R
from inverse_audio_synthesis_tpu_torch.synth import SynthConfig
from inverse_audio_synthesis_tpu_torch.synth import voice as tvoice

torch.set_num_threads(2)

CFG = SynthConfig(batch_size=4, buffer_size_seconds=1.0)  # Tc 441, Ta 44100, ratio 100


def _rel_rms(ref, x):
    return float(np.sqrt(np.mean((ref - x) ** 2)) / (np.sqrt(np.mean(ref**2)) + 1e-12))


def _inputs(batch_num: int, cfg: SynthConfig = CFG, device="cpu"):
    params01 = tvoice.sample_voice_params(batch_num, cfg, device)
    p, routed, midi_f0 = tvoice.compute_controls(params01, cfg)
    return params01, routed.contiguous(), tvoice.fused_scalars(p, midi_f0), tvoice.make_noise(cfg, device)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the render kernel has no CPU mode")
    return torch.device("cuda")


def test_geometry_gate():
    assert tvoice.fused_render_available(CFG)
    assert tvoice.fused_render_available(SynthConfig(batch_size=1))  # 4 s full config
    assert not tvoice.fused_render_available(
        SynthConfig(batch_size=1, buffer_size_seconds=3 * 64 * 64 / 44100)
    )
    assert R.fused_render_supported(2, 128 * 10, 10) and not R.fused_render_supported(2, 129 * 10, 10)


@pytest.mark.parametrize("batch_num", [42, 7, 1234])
def test_plain_matches_jax_pallas_kernel(batch_num):
    """Identical inputs through the JAX kernel (interpret mode) and the plain
    version. The two differ only in float association inside a segment and a
    tile (JAX: matmul prefixes and an XLA mean; port: each lane's run summed in
    order, warp-shaped butterflies and scans). Measured at 1 s, batch 4: max
    0.0095, rel-rms up to 1.5e-3 — far inside the repo's fused-vs-jnp bound
    (0.08, 0.01), so the tighter bound is held here."""
    import jax.numpy as jnp

    from inverse_audio_synthesis_tpu.ops.pallas.render import render_audio_fused as jax_fused

    _, routed, scalars, noise = _inputs(batch_num)
    ref = np.asarray(
        jax_fused(
            jnp.asarray(routed.numpy()), jnp.asarray(scalars.numpy()),
            jnp.asarray(noise.numpy()), 44100.0, interpret=True,
        )
    )
    got = R.render_audio_fused(routed, scalars, noise, 44100.0).numpy()
    assert got.shape == ref.shape == (4, 44100)
    assert np.abs(got - ref).max() < 0.03
    assert _rel_rms(ref, got) < 3e-3


@pytest.mark.parametrize("batch_num", [42, 7])
def test_plain_matches_jax_render_voice(batch_num):
    """Batch number -> audio through the port's fused path vs the JAX portable
    render, within the repo's render bound (tests/test_pallas_render.py)."""
    from inverse_audio_synthesis_tpu.synth import SynthConfig as JSynthConfig
    from inverse_audio_synthesis_tpu.synth import voice as jvoice

    jcfg = JSynthConfig(batch_size=4, buffer_size_seconds=1.0)
    ref = np.asarray(jvoice.render_voice(jvoice.sample_voice_params(batch_num, jcfg), jcfg))
    got = tvoice.render_voice_auto(tvoice.sample_voice_params(batch_num, CFG), CFG).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() < 0.08
    assert _rel_rms(ref, got) < 0.01


def test_plain_matches_port_render_voice_with_padding():
    """A control length that does not fill its last tile (Tc 130), against
    the port's own portable render."""
    cfg = SynthConfig(batch_size=3, buffer_size_seconds=130 / 441)
    assert cfg.control_buffer_size == 130 and tvoice.fused_render_available(cfg)
    params01, routed, scalars, noise = _inputs(5, cfg)
    got = R.render_audio_plain(routed, scalars, noise, 44100.0).numpy()
    ref = tvoice.render_voice(params01, cfg, noise).numpy()
    assert got.shape == ref.shape == (3, 13000)
    assert np.abs(got - ref).max() < 0.08 and _rel_rms(ref, got) < 0.01


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    _, routed, scalars, noise = _inputs(3)
    before = dict(R.launch_counts)
    out = R.render_audio_fused(routed, scalars, noise, 44100.0)
    assert R.launch_counts == before  # only a CUDA launch counts
    torch.testing.assert_close(out, R.render_audio_plain(routed, scalars, noise, 44100.0), rtol=0, atol=0)


def test_wrapper_rejects_unsupported_geometry():
    routed = torch.zeros(2, 5, 10)
    with pytest.raises(ValueError):
        R.render_audio_fused(routed, torch.zeros(2, 16), torch.zeros(2, 1005), 44100.0)
    with pytest.raises(ValueError):
        R.render_audio_fused(torch.zeros(2, 4, 10), torch.zeros(2, 16), torch.zeros(2, 1000), 44100.0)


def test_tile_scan_is_an_inclusive_prefix():
    x = torch.rand(3, 2, R.SEG_TILE, dtype=torch.float64)
    torch.testing.assert_close(R._tile_inclusive_scan(x), torch.cumsum(x, -1))


@pytest.mark.parametrize("ratio", [2, 7, 100, 128])
def test_run_slots_cover_each_sample_once(ratio):
    """Lane k's run holds samples k*run .. k*run + run - 1; the slots past the
    ratio hold none, and no lane is left without work but the last ones."""
    j, holds, jw = R._slots(ratio, "cpu")
    run = R.run_length(ratio)
    assert j.shape == holds.shape == jw.shape == (R.LANES, run) and run <= R.MAX_RUN
    assert j[holds].tolist() == list(range(ratio))
    expect = (np.arange(R.LANES * run, dtype=np.float32) + np.float32(0.5)) / np.float32(ratio) - np.float32(0.5)
    np.testing.assert_array_equal(jw.reshape(-1).numpy(), expect)


@pytest.mark.parametrize("ratio", [2, 7, 100, 128])
def test_segment_phase_is_the_prefix_sum(ratio):
    """The kernels' association of a segment's phase (each lane's run summed in
    order, the butterfly over lanes, mean plus the lanes' exclusive residual scan)
    against a float64 prefix sum of the same increments: within 1e-6 of the
    segment's total at every sample, the wrapped total likewise (measured: up to
    8.2e-8 and 7.6e-8; float32 itself resolves 100 rad only to 7.6e-6)."""
    rng = np.random.RandomState(ratio)
    run = R.run_length(ratio)
    d = rng.uniform(0.01, 1.8, size=(3, 5, ratio)).astype(np.float32)
    slots = np.zeros((3, 5, R.LANES * run), np.float32)
    slots[..., :ratio] = d
    _, holds, _ = R._slots(ratio, "cpu")
    mean, prefix, total = R.segment_phase(torch.from_numpy(slots).reshape(3, 5, R.LANES, run), holds, ratio)
    ramp = torch.arange(1, R.LANES * run + 1, dtype=torch.float32)
    within = (mean[..., None] * ramp + prefix.reshape(3, 5, -1))[..., :ratio].numpy()
    ref = np.cumsum(d.astype(np.float64), axis=-1)
    assert (np.abs(within - ref) / ref[..., -1:]).max() <= 1e-6
    gap = np.abs(total.numpy() - np.mod(ref[..., -1], 2 * np.pi))
    assert (np.minimum(gap, 2 * np.pi - gap) / ref[..., -1]).max() <= 1e-6


def test_chained_tile_carry_is_the_sequential_fold():
    """Tile k's carry from the chain incl[k] = mod(incl[k-1] + total[k]) is, bit
    for bit, the fold c = mod(c + total[j]) over j < k that each block of the
    two-launch design computed; the backward's chained suffix likewise."""
    from inverse_audio_synthesis_tpu_torch.ops.scan_ops import TWO_PI, fmod_floor

    rng = np.random.RandomState(3)
    totals = torch.from_numpy(rng.uniform(0, 2 * np.pi, size=(4, 56)).astype(np.float32))
    chained = R.chained_tile_carry(totals)
    sums = torch.from_numpy(rng.randn(4, 56).astype(np.float32))
    later = R.chained_tile_suffix(sums)
    for k in range(56):
        c = torch.zeros(4)
        for j in range(k):
            c = fmod_floor(c + totals[:, j], TWO_PI)
        assert torch.equal(chained[:, k], c)
        s = torch.zeros(4)
        for j in range(55, k, -1):
            s = s + sums[:, j]
        assert torch.equal(later[:, k], s)


def test_ragged_last_tile_matches_a_full_one():
    """Tc 130 leaves 2 segments in its last tile of 32. Edge-padding the controls
    to 160 segments gives the padded segments the controls they are computed with,
    so the audio, means and offsets agree bit for bit with the full tiles'."""
    cfg = SynthConfig(batch_size=2, buffer_size_seconds=130 / 441)
    _, routed, scalars, noise = _inputs(9, cfg)
    short = R.render_audio_plain(routed, scalars, noise, 44100.0, save_phase=True)
    tcp = -(-130 // R.SEG_TILE) * R.SEG_TILE
    long_routed = torch.nn.functional.pad(routed, (0, tcp - 130), mode="replicate")
    long_noise = torch.nn.functional.pad(noise, (0, (tcp - 130) * 100))
    full = R.render_audio_plain(long_routed, scalars, long_noise, 44100.0, save_phase=True)
    assert tcp == 160 and short[1].shape == full[1].shape == (2, 2, 160)
    assert torch.equal(short[0], full[0][:, :13000])
    assert torch.equal(short[1], full[1]) and torch.equal(short[2], full[2])


def test_ptxas_report_reads_the_run_instantiation():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113render_kernelILi7EEEvPKf' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_113render_kernelILi7EEEvPKf",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers, 1700 bytes smem, 600 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113render_kernelILi13EEEvPKf' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_113render_kernelILi13EEEvPKf",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 80 registers, used 1 barriers, 1712 bytes smem, 600 bytes cmem[0]",
    ])
    assert R.ptxas_report(log, 13) == dict(stack_bytes=8, spill_stores=4, spill_loads=4,
                                           registers=80, smem_bytes=1712)
    assert R.ptxas_report(log, 7)["registers"] == 40 and R.ptxas_report(log, 3) == {}


def test_dphi_scale_rounds_once():
    assert R.dphi_scale(44100.0) == float(np.float32(2.0 * np.pi / 44100.0))


_FAKE_NVCC = """#!/bin/sh
while [ "$#" -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done
echo run >> "{calls}"
echo "ptxas info    : Used 40 registers"
printf lib > "$out"
exit {rc}
"""


@pytest.mark.parametrize("rc", [0, 3])
def test_build_runs_one_nvcc_per_source(tmp_path, monkeypatch, rc):
    """The build with a stand-in nvcc on PATH: one process per source, each
    library renamed into place beside its log and reused by the next build; a
    failing nvcc raises with its output and leaves no file behind."""
    bin_dir, build = tmp_path / "bin", tmp_path / "kernels"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(calls=tmp_path / "calls", rc=rc))
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    monkeypatch.setattr(R, "BUILD_DIR", build)
    if rc:
        with pytest.raises(RuntimeError, match="nvcc render_fwd.cu failed"):
            R.build_render_libraries()
        assert list(build.iterdir()) == []
        return
    libs = R.build_render_libraries()
    assert set(libs) == {"render_fwd", "render_bwd"}
    for lib in libs.values():
        assert lib.read_text() == "lib" and "registers" in lib.with_suffix(".log").read_text()
    assert R.build_render_libraries() == libs
    assert (tmp_path / "calls").read_text().count("run") == 2


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4, 16])
def test_cuda_kernel_matches_plain(cuda_device, batch):
    cfg = SynthConfig(batch_size=batch, buffer_size_seconds=4.0)
    _, routed, scalars, noise = _inputs(11, cfg, cuda_device)
    before = R.launch_counts["render_fwd"]
    out = R.render_audio_fused(routed, scalars, noise, 44100.0)
    torch.cuda.synchronize()
    assert R.launch_counts["render_fwd"] == before + 1
    ref = R.render_audio_plain(routed, scalars, noise, 44100.0)
    err = (out - ref).abs()
    assert float(err.max()) <= 2e-3
    assert float(err.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4, 16])
def test_cuda_kernel_repeats_bit_for_bit_and_matches_plain(cuda_device, batch):
    """One launch per call; a second call gives the same bits; audio, means and
    offsets equal the plain version's bit for bit."""
    cfg = SynthConfig(batch_size=batch, buffer_size_seconds=4.0)
    _, routed, scalars, noise = _inputs(12, cfg, cuda_device)
    before = R.launch_counts["render_fwd"]
    first = R.render_audio_fused(routed, scalars, noise, 44100.0, save_phase=True)
    second = R.render_audio_fused(routed, scalars, noise, 44100.0, save_phase=True)
    torch.cuda.synchronize()
    assert R.launch_counts["render_fwd"] == before + 2
    plain = R.render_audio_plain(routed, scalars, noise, 44100.0, save_phase=True)
    for a, b, c in zip(first, second, plain):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_cuda_division_remainder_and_floor_sequences_are_exact(cuda_device):
    assert R.sequence_mismatches() == (0, 0, 0, 0)


@pytest.mark.cuda
def test_cuda_kernel_refuses_bad_layout(cuda_device):
    _, routed, scalars, noise = _inputs(2, CFG, cuda_device)
    with pytest.raises(ValueError):
        R.render_audio_fused(routed, scalars.double(), noise, 44100.0)
    with pytest.raises(ValueError):
        R.render_audio_fused(routed, scalars, noise.t().contiguous().t(), 44100.0)
