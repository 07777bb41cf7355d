"""The port's small modules against the JAX package: the parameter summary, the
PQMF filter-range diagnostic and synthesis, byte scaling, the run utilities and
the profiling helpers."""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_overrides
from inverse_audio_synthesis_tpu.ops import imgscale8 as jimgscale8
from inverse_audio_synthesis_tpu.ops.pqmf import PQMF as JPQMF
from inverse_audio_synthesis_tpu.parallel.mesh import create_mesh
from inverse_audio_synthesis_tpu.train.pretrain import VicregPretrainTask as JaxTask
from inverse_audio_synthesis_tpu.utils import summary as jsummary
from inverse_audio_synthesis_tpu.utils.audio_io import read_wav as jread_wav
from inverse_audio_synthesis_tpu.utils.config import load_config as jload_config
from inverse_audio_synthesis_tpu_torch.ops import imgscale8
from inverse_audio_synthesis_tpu_torch.ops.pqmf import PQMF
from inverse_audio_synthesis_tpu_torch.parallel.mesh import Mesh, apply_mesh
from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask
from inverse_audio_synthesis_tpu_torch.utils import profiling, summary, utils
from inverse_audio_synthesis_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


# -- the parameter summary ------------------------------------------------------------


@pytest.mark.parametrize("overrides", [tiny_overrides(), tiny_overrides(**{"param_embed.hidden_norm": "nn.Identity"})])
def test_summarize_params_matches_jax(overrides):
    """Rows (the JAX tree's names to depth 2), counts and the total, character
    for character, for the tiny config with and without hidden BatchNorms."""
    jtask = JaxTask(jload_config(overrides=overrides), create_mesh(1, 1, devices=jax.devices()[:1]))
    want = jsummary.summarize_params(jtask.init_state().params, max_depth=2)
    model = VicregPretrainTask(load_config(overrides=overrides + ["platform=cpu"])).init_state().model
    assert summary.summarize_params(model, max_depth=2) == want
    assert summary.param_count(model) == int(re.search(r"TOTAL\s+([\d,]+)", want)[1].replace(",", ""))
    deep = summary.summarize_params(model, max_depth=4)
    assert "backbone_audio/vision_model/stem/bn" in deep


def test_summary_counts_the_full_model_under_tensor_parallelism():
    """A rank's shard of the projector, summarized with its mesh, gives the full
    model's rows (the mesh here carries stand-in groups: no collective runs)."""
    model = VicregPretrainTask(load_config(overrides=tiny_overrides() + ["platform=cpu"])).init_state().model
    full = summary.summarize_params(model)
    mesh = Mesh(data=1, model=2, data_index=0, model_index=1, data_group=object(), model_group=object())
    apply_mesh(model, mesh)
    assert model.projector.lin0.weight.shape[0] == 32  # this rank's half of 64
    assert summary.summarize_params(model, mesh=mesh) == full
    assert summary.summarize_params(model) != full


# -- the PQMF filter range and synthesis ----------------------------------------------


def test_vendored_clip_is_the_jax_packages():
    ours = REPO / "inverse_audio_synthesis_tpu_torch" / "assets" / "test_clip.wav"
    theirs = REPO / "inverse_audio_synthesis_tpu" / "assets" / "test_clip.wav"
    assert ours.read_bytes() == theirs.read_bytes()


def test_filter_range_stats_match_jax():
    """The CLI's diagnostic of the vendored clip, at the PQMF's parity bound."""
    clip, _ = jread_wav(REPO / "inverse_audio_synthesis_tpu" / "assets" / "test_clip.wav")
    want = jsummary.filter_range_stats(clip.mean(axis=1)[:176400])
    got = summary.clip_filter_range_stats()
    assert sorted(got) == sorted(want) and len(got) == 9
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-4), k


@pytest.mark.parametrize("n_bands", [3, 4])
def test_pqmf_synthesis_matches_jax(n_bands):
    rng = np.random.RandomState(n_bands)
    x = rng.randn(2, n_bands, 700).astype(np.float32)
    want = np.asarray(JPQMF(n_bands=n_bands).synthesis(jnp.asarray(x)))
    got = PQMF(n_bands=n_bands).synthesis(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1, 700 * n_bands)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_pqmf_round_trip_on_the_clip():
    """analysis then synthesis: tests/test_pqmf.py's round-trip bounds (one
    sample of delay), and the JAX package's reconstruction within 1e-4."""
    clip, _ = jread_wav(REPO / "inverse_audio_synthesis_tpu" / "assets" / "test_clip.wav")
    x = clip.mean(axis=1)[:176400].astype(np.float32)
    for n_bands, max_err in [(4, 0.2), (3, 0.75)]:
        pqmf = PQMF(n_bands=n_bands)
        recon = pqmf.synthesis(pqmf.analysis(torch.from_numpy(x[None, None, :])))[0, 0].numpy()
        a, b = x[:-1][1000:-1000], recon[1:][1000:-1000]
        err = np.sqrt(np.mean((a - b) ** 2)) / (np.sqrt(np.mean(a**2)) + 1e-9)
        assert err < max_err, (n_bands, err)
        jp = JPQMF(n_bands=n_bands)
        want = np.asarray(jp.synthesis(jp.analysis(jnp.asarray(x[None, None, :]))))[0, 0]
        np.testing.assert_allclose(recon, want, atol=1e-4)


def test_pqmf_synthesis_runs_with_autocast_off():
    x = torch.randn(1, 3, 100)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = PQMF(n_bands=3).synthesis(x)
    assert y.dtype == torch.float32
    with pytest.raises(ValueError, match="expected"):
        PQMF(n_bands=3).synthesis(torch.zeros(1, 4, 10))


# -- byte scaling ---------------------------------------------------------------------


def test_scale8_and_unscale8_match_jax():
    """scale8 bit for bit, out-of-range inputs (clipped to 0 and 255) among them;
    unscale8 within rtol 1e-6; the round trip within one step."""
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(4000) * 2.5, [-1e6, 1e6, imgscale8.minval, imgscale8.maxval, 0.0]])
    x = x.astype(np.float32)
    got = imgscale8.scale8(torch.from_numpy(x))
    want = np.asarray(jimgscale8.scale8(jnp.asarray(x)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() == 0 and got.max() == 255
    u = np.arange(256, dtype=np.uint8)
    np.testing.assert_allclose(imgscale8.unscale8(torch.from_numpy(u)).numpy(),
                               np.asarray(jimgscale8.unscale8(jnp.asarray(u))), rtol=1e-6)
    inside = torch.linspace(-1.6, 1.5, 1000)
    back = imgscale8.unscale8(imgscale8.scale8(inside))
    assert float((back - inside).abs().max()) < (imgscale8.maxval - imgscale8.minval) / 255.0


# -- run utilities and profiling ------------------------------------------------------


def test_utcstr_and_git_sha():
    assert re.fullmatch(r"\d{4}-\d{2}-\d{2}-\d{2}-\d{2}-\d{2}", utils.utcstr())
    sha = utils.git_sha()
    assert sha == "" or re.fullmatch(r"[0-9a-f]{40}", sha)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof"), cuda=False):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = (tmp_path / "prof").glob("trace-*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_nan_debugging_is_undone_and_raises_at_the_backward_op():
    assert not torch.is_anomaly_enabled()
    w = torch.tensor([1.0, float("nan")], requires_grad=True)
    with profiling.nan_debugging():
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match=r"Function '\w+Backward\d*' returned nan"):
            torch.autograd.grad((w * torch.tensor([2.0, 3.0])).sqrt().sum(), w)
    assert not torch.is_anomaly_enabled()
    profiling.enable_nan_debugging()
    try:
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)

