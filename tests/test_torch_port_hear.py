"""The port's HEAR embedding API against the JAX package's ``eval/hear.py``.

The tiny config's towers with the JAX weights (carried across with
``models/jax_weights.py``), the same numpy audio through both APIs; plus the
JAX test's shape, spacing and raw-slice checks, ``load_model`` and the CLI.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_overrides
from inverse_audio_synthesis_tpu.eval import hear as jhear
from inverse_audio_synthesis_tpu.parallel.mesh import create_mesh
from inverse_audio_synthesis_tpu.train.pretrain import VicregPretrainTask as JaxPretrain
from inverse_audio_synthesis_tpu.utils.config import load_config as jload_config
from inverse_audio_synthesis_tpu_torch.eval import hear
from inverse_audio_synthesis_tpu_torch.models.jax_weights import load_jax_variables
from inverse_audio_synthesis_tpu_torch.train.checkpoint import CheckpointManager
from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask
from inverse_audio_synthesis_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = tiny_overrides(**{"param_embed.dropout": 0})


def _hear_model(module, task, state, cfg):
    return module.HearModel(task=task, state=state, sample_rate=cfg.torchsynth.rate,
                            scene_embedding_size=cfg.dim, timestamp_embedding_size=cfg.dim)


@pytest.fixture(scope="module")
def models():
    """(JAX HearModel, port HearModel) with the same weights, and a clip of 2.5 windows."""
    jcfg = jload_config(overrides=TINY)
    jtask = JaxPretrain(jcfg, create_mesh(1, 1, devices=jax.devices()[:1]))
    jstate = jtask.init_state()
    variables = jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats})
    cfg = load_config(overrides=TINY + ["platform=cpu"])
    task = VicregPretrainTask(cfg)
    state = task.init_state()
    load_jax_variables(state.model, variables)
    jm, tm = _hear_model(jhear, jtask, jstate, jcfg), _hear_model(hear, task, state, cfg)
    w = tm.window_samples
    audio = np.random.RandomState(0).uniform(-1, 1, (2, int(2.5 * w))).astype(np.float32)
    return jm, tm, audio


def _close(got, ref, rel=1e-5):
    """Within ``rel`` of the largest |value|: the eval-mode tower bound of
    tests/test_torch_port_models.py (measured 1.3e-6 there)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < rel, err


def test_scene_embeddings_match_jax(models):
    jm, tm, audio = models
    scene = hear.get_scene_embeddings(torch.from_numpy(audio), tm)
    assert scene.shape == (2, tm.scene_embedding_size) and scene.dtype == torch.float32
    _close(scene.numpy(), jhear.get_scene_embeddings(jnp.asarray(audio), jm))


@pytest.mark.parametrize("hop", ["half_window", "window_and_a_half", "50ms"])
def test_timestamp_embeddings_match_jax(models, hop):
    """The same n_ts, the same centres, the same zero-padded edge windows (the JAX
    function pads the timestamp axis to a chunk multiple, the port does not)."""
    jm, tm, audio = models
    w, sr = tm.window_samples, tm.sample_rate
    hop_ms = {"half_window": w / 2, "window_and_a_half": 1.5 * w, "50ms": 0.05 * sr}[hop] / sr * 1000.0
    emb, ts = hear.get_timestamp_embeddings(torch.from_numpy(audio), tm, hop_ms=hop_ms, chunk=4)
    jemb, jts = jhear.get_timestamp_embeddings(jnp.asarray(audio), jm, hop_ms=hop_ms, chunk=4)
    assert emb.shape == jemb.shape and ts.shape == jts.shape
    np.testing.assert_array_equal(ts.numpy(), np.asarray(jts))
    _close(emb.numpy(), jemb)


def test_timestamp_api_shapes_and_raw_slices(models):
    """tests/test_hear.py's checks on the port: 5 timestamps at half-window hops,
    evenly spaced and centred in the hop, and an in-bounds window equal to the
    tower on the raw slice it covers (the JAX test's tolerance)."""
    _, tm, audio = models
    w, sr = tm.window_samples, tm.sample_rate
    hop_ms = w / 2 / sr * 1000.0
    emb, ts = hear.get_timestamp_embeddings(torch.from_numpy(audio), tm, hop_ms=hop_ms, chunk=4)
    assert emb.shape == (2, 5, tm.timestamp_embedding_size) and ts.shape == (2, 5)
    assert torch.isfinite(emb).all()
    np.testing.assert_allclose(np.diff(ts[0].numpy()), hop_ms, rtol=1e-3)
    np.testing.assert_allclose(float(ts[0, 0]), hop_ms / 2, rtol=1e-2)
    hop, k = w // 2, 2
    start = k * hop + hop // 2 - w // 2
    assert 0 <= start and start + w <= audio.shape[1]
    ref = tm.task.embed_audio(tm.state, torch.from_numpy(audio[:, None, start : start + w]))
    np.testing.assert_allclose(emb[:, k].numpy(), ref.numpy(), rtol=2e-4, atol=2e-5)
    # one window's worth of audio or less: one scene window, one timestamp per hop
    short = torch.from_numpy(audio[:, : w // 3])
    assert hear.get_scene_embeddings(short, tm).shape == (2, tm.scene_embedding_size)


def test_load_model_restores_the_checkpoint(tmp_path):
    cfg = load_config(overrides=TINY + ["platform=cpu"])
    task = VicregPretrainTask(cfg)
    state = task.init_state()
    with torch.no_grad():
        state.model.backbone_audio.conv1.bias.fill_(0.5)
    CheckpointManager(str(tmp_path / "vicreg")).save(state, 3)
    model = hear.load_model(cfg, str(tmp_path / "vicreg"))
    assert model.window_samples == task.synth.buffer_size and model.scene_embedding_size == cfg.dim
    assert torch.equal(model.state.model.backbone_audio.conv1.bias, torch.full((cfg.dim,), 0.5))
    fresh = hear.load_model(cfg)
    assert not torch.equal(fresh.state.model.backbone_audio.conv1.bias, torch.full((cfg.dim,), 0.5))


FUSED = tiny_overrides(**{  # the 60 x 80 size the fused render takes
    "image.height": 60, "image.width": 80, "torchsynth.buffer_size_seconds": 14400 / 44100,
})


def test_cli_runs_on_cpu(tmp_path):
    cfg = load_config(overrides=FUSED + ["platform=cpu"])
    CheckpointManager(str(tmp_path / "checkpoints" / "vicreg")).save(VicregPretrainTask(cfg).init_state(), 1)
    proc = subprocess.run(
        [sys.executable, "-m", "inverse_audio_synthesis_tpu_torch.heareval", *FUSED,
         "platform=cpu", f"run_dir={tmp_path}"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "2"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert "loaded vicreg checkpoint step 1" in lines
    assert "(4, 32)" in lines
    # 2.5 windows of 14,400 samples at a 2,205-sample hop: 17 timestamps
    assert lines[-1] == "scene (2, 32); timestamps (2, 17, 32) at 50.0 ms hop"
