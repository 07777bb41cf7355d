"""The port's serving export (``serve/export.py``) and its CLIs' guards.

Mirrors tests/test_export.py: every artifact round-trips through bytes and
reproduces the live function (bit for bit for ``embed_audio`` and
``predict_params``, within 2e-6 for ``render``, the JAX test's bound); a wrong
batch shape raises; weights ride as inputs, so an artifact of the tiny config
stays under 1 MB; the manifest has the JAX ``write_manifest``'s keys. Then the
export CLI on the CPU, and the three new CLIs' refusal to fall back to the CPU.
"""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import tiny_overrides
from inverse_audio_synthesis_tpu.serve import write_manifest as jwrite_manifest
from inverse_audio_synthesis_tpu.utils.config import load_config as jload_config
from inverse_audio_synthesis_tpu_torch import evaluate_audio_representations, export_model, heareval
from inverse_audio_synthesis_tpu_torch.serve import (
    export_embed_audio,
    export_predict_params,
    export_render,
    load_exported,
    model_weights,
    save_exported,
    write_manifest,
)
from inverse_audio_synthesis_tpu_torch.synth import SynthConfig, prng
from inverse_audio_synthesis_tpu_torch.synth.voice import render_voice, sample_voice_params
from inverse_audio_synthesis_tpu_torch.train.checkpoint import CheckpointManager
from inverse_audio_synthesis_tpu_torch.train.downstream import AudioToParamsTask
from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask
from inverse_audio_synthesis_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = tiny_overrides(**{"audio_to_params.batch_size": 8})


def _round_trip(exp):
    buf = io.BytesIO()
    save_exported(exp, buf)
    size = len(buf.getvalue())
    buf.seek(0)
    return load_exported(buf), size


def _audio(task, batch, seed):
    return prng.uniform(prng.prng_key(seed), (batch, 1, task.synth.buffer_size), -1.0, 1.0)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_embed_audio_round_trip(precision):
    """bf16 puts the towers' autocast region in the program: the artifact still
    computes what the live function does, bit for bit."""
    task = VicregPretrainTask(load_config(overrides=TINY + [f"precision={precision}", "platform=cpu"]))
    state = task.init_state()
    loaded, size = _round_trip(export_embed_audio(task, state, batch=4))
    assert size < 1 << 20, size  # the weights are not in it
    audio = _audio(task, 4, 0)
    weights = model_weights(state.model)
    got = loaded.module()(weights, audio)
    want = task.embed_audio(state, audio)
    assert got.shape == (4, 32) and got.dtype == want.dtype
    assert torch.equal(got, want)
    # other weights in, other embeddings out: nothing of the exported model is baked in
    shifted = {k: (v + 0.1 if k.endswith("conv1.bias") else v) for k, v in weights.items()}
    assert not torch.equal(loaded.module()(shifted, audio), got)


def test_predict_params_round_trip():
    cfg = load_config(overrides=TINY + ["platform=cpu"])
    pre = VicregPretrainTask(cfg)
    task = AudioToParamsTask(cfg, pre, pre.init_state())
    state = task.init_state()
    loaded, size = _round_trip(export_predict_params(task, state, batch=8))
    assert size < 1 << 20, size
    audio = _audio(task, 8, 1)
    got = loaded.module()(model_weights(task.frozen), model_weights(state.model), audio)
    state.model.eval()
    with torch.no_grad(), task._autocast():  # live: frozen audio repr -> head (inference)
        want = state.model(task._audio_repr(audio).float())
    assert got.shape == (8, cfg.nparams)
    assert torch.equal(got, want)
    assert ((got >= 0.0) & (got <= 1.0)).all()  # the sigmoid head's normalized space


def test_render_round_trip():
    """The noise is drawn inside the program from the config's noise seed."""
    cfg = SynthConfig(batch_size=4, buffer_size_seconds=0.05)
    params01 = sample_voice_params(0, cfg)
    loaded, _ = _round_trip(export_render(cfg, 4, "cpu"))
    got = loaded.module()(params01)
    want = render_voice(params01, cfg)
    assert got.shape == (4, cfg.buffer_size)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6, rtol=0)


def test_export_rejects_wrong_shape():
    task = VicregPretrainTask(load_config(overrides=TINY + ["platform=cpu"]))
    state = task.init_state()
    loaded, _ = _round_trip(export_embed_audio(task, state, batch=4))
    with pytest.raises(RuntimeError, match="shape"):
        loaded.module()(model_weights(state.model), torch.zeros((2, 1, task.synth.buffer_size)))


def test_manifest_keys_match_jax(tmp_path):
    entries = {"render": {"in": "(params01[4,78] f32)", "out": "[4,12288] f32", "platforms": ["cpu"]}}
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jwrite_manifest(tmp_path / "jax", jload_config(overrides=TINY), entries)
    write_manifest(tmp_path / "port", load_config(overrides=TINY), entries)
    jm = json.loads((tmp_path / "jax" / "manifest.json").read_text())
    tm = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert tm == jm and set(tm) == {"sample_rate", "buffer_size_seconds", "dim", "nparams", "artifacts"}


def test_export_platforms_other_than_the_device_are_refused():
    export_model.check_platforms(None, "cuda")
    export_model.check_platforms("cuda", "cuda")
    export_model.check_platforms(["cpu"], "cpu")
    for platforms, device in (("tpu,cpu", "cpu"), ("cpu", "cuda"), (["cuda", "rocm"], "cuda")):
        with pytest.raises(ValueError, match="export_platforms"):
            export_model.check_platforms(platforms, device)


@pytest.mark.parametrize("cli", [evaluate_audio_representations, heareval, export_model])
def test_cli_raises_without_cuda_unless_asked_for_the_cpu(cli, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="platform=cpu"):
        cli.app(load_config(overrides=TINY + [f"run_dir={tmp_path}"]))


FUSED = tiny_overrides(**{  # the 60 x 80 size the fused render takes
    "image.height": 60, "image.width": 80, "torchsynth.buffer_size_seconds": 14400 / 44100,
    "audio_to_params.batch_size": 8,
})


def test_cli_runs_on_cpu(tmp_path):
    """All three artifacts (a head checkpoint is there), the manifest with
    export_batch, and each artifact running on the checkpoint's weights."""
    cfg = load_config(overrides=FUSED + ["platform=cpu"])
    pre = VicregPretrainTask(cfg)
    vicreg_state = pre.init_state()
    CheckpointManager(str(tmp_path / "checkpoints" / "vicreg")).save(vicreg_state, 2)
    head_state = AudioToParamsTask(cfg, pre, vicreg_state).init_state()
    CheckpointManager(str(tmp_path / "checkpoints" / "audio_to_params")).save(head_state, 1)
    out = tmp_path / "export"
    proc = subprocess.run(
        [sys.executable, "-m", "inverse_audio_synthesis_tpu_torch.export_model", *FUSED,
         "platform=cpu", f"run_dir={tmp_path}", f"+export_dir={out}", "+export_batch=2",
         "+export_platforms=cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "2"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "loaded vicreg checkpoint step 2" in proc.stdout
    assert "loaded downstream checkpoint step 1" in proc.stdout
    manifest = json.loads((out / "manifest.json").read_text())
    assert sorted(manifest["artifacts"]) == ["embed_audio", "predict_params", "render"]
    assert manifest["artifacts"]["render"]["in"] == "(params01[2,78] f32)"
    weights = torch.load(tmp_path / "checkpoints" / "vicreg" / "step_000000000002" / "state.pt")["model"]
    audio = _audio(pre, 2, 3)
    emb = load_exported(out / "embed_audio.pt2").module()(weights, audio)
    assert torch.equal(emb, pre.embed_audio(vicreg_state, audio))
    assert load_exported(out / "render.pt2").module()(sample_voice_params(0, pre.synth)[:2]).shape == (2, 14400)
