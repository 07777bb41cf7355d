"""The port's public surface against the JAX package's.

Every public top-level function and class of each JAX module, every public
method of those classes and every name an ``__init__.py`` re-exports has a
counterpart of the same name in the port's module at the same path, or an entry
in ``DEVIATIONS`` saying why not and, where the port does the same work, where.
The JAX side is read with ``ast`` only (``ops/pallas/`` is left out: its two
kernels are ``ops/render.py``'s). Below that, the functions that completed the
surface are held against their JAX counterparts on the same numpy inputs.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverse_audio_synthesis_tpu.models import vicreg as jvicreg
from inverse_audio_synthesis_tpu.ops import math_ops as jmath
from inverse_audio_synthesis_tpu.ops import scan_ops as jscan
from inverse_audio_synthesis_tpu.ops import stft as jstft
from inverse_audio_synthesis_tpu.synth import modules as jmodules
from inverse_audio_synthesis_tpu.synth import parameter as jparameter
from inverse_audio_synthesis_tpu.synth import voice as jvoice
from inverse_audio_synthesis_tpu_torch.models import vicreg as tvicreg
from inverse_audio_synthesis_tpu_torch.ops import math_ops as tmath
from inverse_audio_synthesis_tpu_torch.ops import scan_ops as tscan
from inverse_audio_synthesis_tpu_torch.ops import stft as tstft
from inverse_audio_synthesis_tpu_torch.synth import modules as tmodules
from inverse_audio_synthesis_tpu_torch.synth import parameter as tparameter
from inverse_audio_synthesis_tpu_torch.synth import voice as tvoice

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "inverse_audio_synthesis_tpu"
PORT_PKG = "inverse_audio_synthesis_tpu_torch"

_GSPMD = "a GSPMD NamedSharding helper; the port places tensors by rank (parallel/mesh.py: Mesh, shard, apply_mesh)"
_NO_STEP_TIMER = ("unused; the loop logs steps_per_sec and voices_per_sec (train/loop.py), and "
                  "utils/profiling.py:span marks the phases a profiler times")
_MATMUL_DFT = "the matmul-DFT STFT, on ROADMAP's drop list; every method is torch.stft (ops/stft.py:stft)"

# "<module path>:<name>" -> why the port has no counterpart of that name
DEVIATIONS = {
    "parallel/mesh.py:replicated": _GSPMD,
    "parallel/mesh.py:batch_sharding": _GSPMD,
    "parallel/mesh.py:shard_batch": _GSPMD + "; rows are split by parallel/mesh.py:Mesh.local_rows",
    "parallel/mesh.py:param_shardings": _GSPMD + "; the projector's layout is parallel/mesh.py:apply_mesh",
    "parallel/__init__.py:replicated": _GSPMD,
    "parallel/__init__.py:batch_sharding": _GSPMD,
    "parallel/__init__.py:shard_batch": _GSPMD,
    "parallel/__init__.py:param_shardings": _GSPMD,
    "ops/stft.py:frame_signal": "the JAX STFT's gather framing; torch.stft frames inside (ops/stft.py:stft)",
    "ops/stft.py:power_spectrogram_conv": _MATMUL_DFT,
    "ops/stft.py:power_spectrogram_matmul": _MATMUL_DFT,
    "ops/stft.py:magnitude_stft_matmul": _MATMUL_DFT,
    "train/optim.py:NonFiniteGuardState": "an optax state tuple; the guard's state is train/optim.py:_Guarded.count/total_notfinite",
    "train/optim.py:reject_nonfinite_updates": "an optax transform; the guard is folded into each optimizer (train/optim.py:_Guarded)",
    "train/optim.py:FusedLarsState": "an optax state tuple; train/optim.py:FusedLars holds its count",
    "train/optim.py:fused_lars": "an optax transform; train/optim.py:FusedLars does its work",
    "train/optim.py:Fp32MasterState": "an optax state tuple; train/optim.py:Fp32Master holds the masters",
    "train/optim.py:with_fp32_master": "an optax transform; train/optim.py:Fp32Master does its work",
    "train/optim.py:total_notfinite": "walks an optax state pytree; the port reads optimizer.total_notfinite",
    "models/vicreg.py:VICRegModule.setup": "flax's submodule hook; torch builds them in __init__",
    "train/pretrain.py:make_render_fn": "chooses Pallas or jnp and shard_maps the kernel; synth/voice.py:render_voice_auto chooses K1 or the portable render",
    "train/pretrain.py:maybe_bf16_grads": "a jit-time XLA cast of the gradients; under grads_bf16 the port's optimizer rounds them (train/optim.py, in registers in csrc/lars.cu)",
    "utils/utils.py:enable_compile_cache": "XLA's persistent compile cache; the port builds its kernels once per source into build/kernels",
    "utils/profiling.py:StepTimer": _NO_STEP_TIMER,
    "utils/profiling.py:StepTimer.tick": _NO_STEP_TIMER,
    "utils/profiling.py:StepTimer.steps_per_sec": _NO_STEP_TIMER,
    "utils/profiling.py:StepTimer.voices_per_sec": _NO_STEP_TIMER,
}


def _jax_modules():
    return sorted(
        str(p.relative_to(JAX_PKG))
        for p in JAX_PKG.rglob("*.py")
        if p.relative_to(JAX_PKG).parts[:2] != ("ops", "pallas")
    )


def _public_names(path: Path):
    """Public top-level defs and classes, public methods of those classes, and the
    names an ``__init__.py`` imports."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, ast.FunctionDef) and not m.name.startswith("_")]
        elif path.name == "__init__.py" and isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
    return names


def _port_module(rel: str):
    import importlib

    parts = Path(rel).with_suffix("").parts
    name = ".".join((PORT_PKG,) + parts)
    return importlib.import_module(name.removesuffix(".__init__"))


def _has(obj, dotted: str) -> bool:
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


@pytest.mark.parametrize("rel", _jax_modules())
def test_public_surface(rel):
    port = _port_module(rel)
    names = _public_names(JAX_PKG / rel)
    missing = [n for n in names if not _has(port, n) and f"{rel}:{n}" not in DEVIATIONS]
    assert not missing, f"{rel}: no counterpart in the port and no DEVIATIONS entry: {missing}"
    for key in DEVIATIONS:  # an entry names a JAX name the port really lacks
        mod, name = key.split(":")
        if mod == rel:
            assert name in names, f"stale DEVIATIONS entry {key}: not a public JAX name"
            assert not _has(port, name), f"stale DEVIATIONS entry {key}: the port has it"


def test_deviations_name_jax_modules():
    modules = set(_jax_modules())
    assert {k.split(":")[0] for k in DEVIATIONS} <= modules
    assert all(reason.strip() for reason in DEVIATIONS.values())


def test_subpackages_import_no_jax_and_build_no_kernel():
    """Importing every subpackage of the port loads no JAX module and no render
    library (a fresh process: this one has JAX loaded by the JAX tests)."""
    code = (
        "import sys\n"
        f"for m in ('synth', 'models', 'ops', 'train', 'parallel', 'utils', 'eval', 'serve'):\n"
        f"    __import__('{PORT_PKG}.' + m)\n"
        f"from {PORT_PKG}.ops import render\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',"
        " 'inverse_audio_synthesis_tpu')]\n"
        "assert not bad, bad\n"
        "assert not render._libs, render._libs\n"
        "assert not any(render.launch_counts.values())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


# -- the functions that completed the surface, held against JAX ----------------------


def test_to_0to1_roundtrip_and_matches_jax():
    x = np.random.RandomState(11).rand(61).astype(np.float32)
    x[:3] = [0.0, 0.5, 1.0]
    for js, ts in zip(jvoice.VOICE_PARAM_SPECS, tvoice.VOICE_PARAM_SPECS):
        v = np.array(jparameter.from_0to1(js, jnp.asarray(x)))
        ref = np.asarray(jparameter.to_0to1(js, jnp.asarray(v)))
        got = tparameter.to_0to1(ts, torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(got, x, rtol=0, atol=1e-5)  # tests/test_synth.py:45
        # float32 pow: XLA's and torch's powf may differ in the last ulp
        np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-6, err_msg=f"{ts.module}.{ts.name}")


def test_to_0to1_gradient_finite_at_zero():
    for ts in tvoice.VOICE_PARAM_SPECS:
        if ts.curve == 1.0:
            continue
        v = torch.tensor([ts.minimum, (ts.minimum + ts.maximum) / 2.0], requires_grad=True)
        (g,) = torch.autograd.grad(tparameter.to_0to1(ts, v).sum(), v)
        assert torch.isfinite(g).all(), (ts.module, ts.name, g)


def test_upsample_control_matches_jax():
    ctl = np.random.RandomState(12).rand(3, 441).astype(np.float32)
    for n_out in (44_100, 12_288):  # integer and non-integer ratios
        np.testing.assert_allclose(
            tmodules.upsample_control(torch.from_numpy(ctl), n_out).numpy(),
            np.asarray(jmodules.upsample_control(jnp.asarray(ctl), n_out)),
            rtol=0, atol=1e-6,
        )


def test_sin_fast_matches_jax():
    x = np.random.RandomState(13).uniform(-1e3, 1e3, 100_000).astype(np.float32)
    x[:5] = [0.0, np.pi / 2, -np.pi, 1e3, -1e3]
    got = tmath.sin_fast(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmath.sin_fast(jnp.asarray(x))), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got, tmath.sincos_fast(torch.from_numpy(x))[0].numpy())


@pytest.mark.parametrize("length", [100, 128, 20_000])
def test_chunked_cumsum_matches_jax(length):
    x = np.random.RandomState(length).uniform(-0.5, 1.0, (3, length)).astype(np.float32)
    ref = np.asarray(jscan.chunked_cumsum(jnp.asarray(x)))
    got = tscan.chunked_cumsum(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == x.shape
    # within-chunk sums: torch.cumsum here, an exact-f32 dot in JAX
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_off_diagonal_sq_sum_matches_jax_and_the_loss():
    rng = np.random.RandomState(14)
    c = rng.randn(24, 24).astype(np.float32)
    np.testing.assert_allclose(
        float(tvicreg.off_diagonal_sq_sum(torch.from_numpy(c))),
        float(jvicreg.off_diagonal_sq_sum(jnp.asarray(c))), rtol=1e-5)
    # vicreg_loss's covariance term is this sum over each side's covariance
    x, y = (torch.from_numpy(rng.randn(16, 24).astype(np.float32)) for _ in range(2))
    cov_loss = tvicreg.vicreg_loss(x, y)[3]
    expect = 0.0
    for z in (x, y):
        z = z - z.mean(dim=0)
        expect += float(tvicreg.off_diagonal_sq_sum(z.T @ z / 15)) / 24
    np.testing.assert_allclose(float(cov_loss), expect, rtol=1e-4)


def test_exclude_bias_and_norm_matches_jax():
    for shape in ((7,), (3, 4), (2, 3, 5, 5)):
        t = torch.zeros(shape)
        assert tvicreg.exclude_bias_and_norm("w", t) is jvicreg.exclude_bias_and_norm((), np.zeros(shape))
    assert tvicreg.exclude_bias_and_norm("bias", torch.zeros(7)) is False
    assert tvicreg.exclude_bias_and_norm("kernel", torch.zeros(3, 4)) is True


def test_spectral_losses_match_jax_and_mrstft():
    rng = np.random.RandomState(15)
    mp, mt = (np.abs(rng.randn(2, 65, 30)).astype(np.float32) for _ in range(2))
    mp[0, :3] = 0.0  # under the 1e-7 floor
    for tf, jf in ((tstft.spectral_convergence_loss, jstft.spectral_convergence_loss),
                   (tstft.log_stft_magnitude_loss, jstft.log_stft_magnitude_loss)):
        np.testing.assert_allclose(float(tf(torch.from_numpy(mp), torch.from_numpy(mt))),
                                   float(jf(jnp.asarray(mp), jnp.asarray(mt))), rtol=1e-5)
    # the MR-STFT loss at one resolution is the sum of the two terms
    pred, true = (torch.from_numpy(rng.randn(3, 2048).astype(np.float32)) for _ in range(2))
    res = (256, 64, 200)
    mag = [tstft.stft(a, n_fft=res[0], hop_length=res[1], win_length=res[2]).abs() for a in (pred, true)]
    terms = tstft.spectral_convergence_loss(*mag) + tstft.log_stft_magnitude_loss(*mag)
    np.testing.assert_allclose(float(tstft.multi_resolution_stft_loss(pred, true, (res,))),
                               float(terms), rtol=1e-5)


def test_audio_embedding_features_is_forward():
    from inverse_audio_synthesis_tpu_torch.models import AudioEmbedding

    torch.manual_seed(0)
    m = AudioEmbedding(dim=16, image_size=(64, 64)).eval()
    audio = torch.from_numpy(np.random.RandomState(16).randn(2, 1, 3 * 64 * 64).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(m.features(audio), m(audio))
