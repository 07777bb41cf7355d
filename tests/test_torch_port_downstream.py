"""The port's downstream slice against the JAX package, and its checkpoints and CLI.

- One train step of ``AudioToParamsTask`` per objective (embedding, param_mse,
  mel_l1, combined) in both packages, from identical frozen towers and head
  weights (carried across with ``models/jax_weights.py``) and the same batch
  number. The geometry is the tiny config's widths with a 60 x 80 pseudo-image
  (14,400 samples, 144 control steps, ratio 100), which the fused render takes:
  the JAX task's ``_render`` is set here to its fused render in interpret mode
  (its own task picks the kernel only on a TPU), so both sides render through a
  kernel path, forward and backward. ``mel.method`` and ``mel.test_method`` are
  ``fft`` on both sides (the port computes every method in float32). Dropout is
  0: the two packages draw masks from different generators.
- One test step's metrics against the JAX ``_test_metrics_impl``.
- ``mel_chunk`` against the unchunked step, ``frozen_bn: batch``, the collapse
  probe, a checkpoint round trip and a resumed ``Trainer.fit``, and both CLIs end
  to end on the CPU.
"""

import copy
import dataclasses
import logging
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import tiny_overrides
from inverse_audio_synthesis_tpu.parallel.mesh import create_mesh
from inverse_audio_synthesis_tpu.synth import voice as jvoice
from inverse_audio_synthesis_tpu.train.downstream import AudioToParamsTask as JaxDownstream
from inverse_audio_synthesis_tpu.train.pretrain import VicregPretrainTask as JaxPretrain
from inverse_audio_synthesis_tpu.utils.config import load_config as jload_config
from inverse_audio_synthesis_tpu_torch.models.jax_weights import (
    export_jax_variables,
    flatten,
    load_jax_variables,
)
from inverse_audio_synthesis_tpu_torch.ops import launches
from inverse_audio_synthesis_tpu_torch.train.checkpoint import CheckpointManager
from inverse_audio_synthesis_tpu_torch.train.downstream import AudioToParamsTask
from inverse_audio_synthesis_tpu_torch.train.loop import Trainer
from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask
from inverse_audio_synthesis_tpu_torch.train.runsetup import BatchNumberSplit
from inverse_audio_synthesis_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
FUSED = {  # 3 x 60 x 80 = 14,400 samples = 144 control steps x 100
    "image.height": 60, "image.width": 80, "torchsynth.buffer_size_seconds": 14400 / 44100,
}
SLICE = tiny_overrides(**FUSED, **{
    "param_embed.dropout": 0, "audio_to_params.dropout": 0, "audio_to_params.batch_size": 8,
    "mel.method": "fft", "mel.test_method": "fft",
})
OBJECTIVES = ("embedding", "param_mse", "mel_l1", "combined")
BATCH_NUM = 11


def _port_pretrain(overrides):
    task = VicregPretrainTask(load_config(overrides=list(overrides) + ["platform=cpu"]))
    return task, task.init_state()


@pytest.fixture(scope="module")
def towers():
    """The JAX pretrain task and state, and the port's with the same weights."""
    jtask = JaxPretrain(jload_config(overrides=SLICE), create_mesh(1, 1, devices=jax.devices()[:1]))
    jstate = jtask.init_state()
    variables = jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats})
    task, state = _port_pretrain(SLICE)
    load_jax_variables(state.model, variables)
    return jtask, jstate, task, state


def _jax_downstream(towers, overrides):
    jpre, jstate, _, _ = towers
    jtask = JaxDownstream(jload_config(overrides=SLICE + overrides), jpre.mesh, jpre, jstate)
    # both sides through a kernel path: the JAX fused render in interpret mode
    jtask._render = lambda p, noise: jvoice.render_voice_fused(p, jtask.synth, True, None, noise)
    return jtask


def _port_downstream(towers, overrides):
    _, _, pre, state = towers
    return AudioToParamsTask(load_config(overrides=SLICE + overrides + ["platform=cpu"]), pre, state)


def _head_vars(jstate):
    return jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats})


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _one_step_both(towers, objective):
    jtask = _jax_downstream(towers, [f"audio_to_params.loss={objective}"])
    task = _port_downstream(towers, [f"audio_to_params.loss={objective}"])
    jstate = jtask.init_state()
    before = _head_vars(jstate)
    state = task.init_state()
    load_jax_variables(state.model, before)
    frozen_before = {k: v.clone() for k, v in task.frozen.state_dict().items()}
    jstate, jm = jtask.train_step(jstate, BATCH_NUM)
    state, m = task.train_step(state, BATCH_NUM)
    return {
        "jax_metrics": {k: float(v) for k, v in jax.device_get(jm).items()},
        "metrics": {k: float(v) for k, v in m.items()},
        "before": flatten(before),
        "jax_after": flatten(_head_vars(jstate)),
        "after": flatten(export_jax_variables(state.model, before)),
        "frozen_before": frozen_before,
        "task": task,
        "state": state,
    }


# per objective: the least cosine of a tensor's update, and its norm ratio's
# distance from 1 (measured values in the test's docstring)
UPDATE_COS = {"embedding": 0.9999, "param_mse": 0.9999, "mel_l1": 0.99, "combined": 0.99}
NORM_RTOL = {"embedding": 1e-3, "param_mse": 1e-3, "mel_l1": 5e-2, "combined": 5e-2}


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_one_train_step_matches_jax(towers, objective):
    """Loss, each logged component and the frozen-VICReg diagnostic, then the
    head's update. embedding and param_mse differ only by float32 rounding in
    the towers and head. mel_l1 renders with the two packages' forward kernel
    paths, whose phases round differently, and backpropagates through K2's
    plain version vs the JAX K2 in interpret mode.

    Measured: logged values within 4.5e-7 to 1.3e-5 relative (held at 1e-4);
    the least update cosine 0.9999998 (embedding), 0.99999990 (param_mse),
    0.99903 (mel_l1), 0.99988 (combined); update norm ratios within 1.3e-4,
    1.5e-5, 1.3e-2 and 3.5e-3 of 1. LARS fixes a decayed tensor's update norm
    unless its gradient is as small as weight decay times the weight, as the mel
    term's gradients nearly are. The biases that feed a BatchNorm have a zero
    gradient in exact arithmetic: both sides move them by rounding noise only
    (below 5e-6)."""
    r = _one_step_both(towers, objective)
    jm, tm = r["jax_metrics"], r["metrics"]
    assert set(tm) == set(jm)
    for key in jm:
        assert np.isfinite(tm[key])
        assert tm[key] == pytest.approx(jm[key], rel=1e-4), key
    if objective == "combined":
        weights = {"param_mse": 1.0, "mel_l1": 0.1}
        total = sum(w * tm[f"audio_to_params/train/{k}"] for k, w in weights.items())
        assert tm["audio_to_params/train/loss"] == pytest.approx(total, rel=1e-6)
    before, jafter, after = r["before"], r["jax_after"], r["after"]
    checked = 0
    for key in before:
        if not key.startswith("params/"):
            continue
        dj, dt = jafter[key] - before[key], after[key] - before[key]
        if np.linalg.norm(dj) < 1e-5:  # biases that feed a BatchNorm: rounding noise only
            assert np.linalg.norm(dt) < 1e-5, key
            continue
        assert _cos(dj, dt) >= UPDATE_COS[objective], key
        assert np.linalg.norm(dt) / np.linalg.norm(dj) == pytest.approx(1.0, rel=NORM_RTOL[objective]), key
        checked += 1
    assert checked == 8
    for key in before:
        if key.startswith("batch_stats/"):
            np.testing.assert_allclose(after[key], jafter[key], rtol=1e-4, atol=1e-6, err_msg=key)
    # frozen means frozen
    for k, v in r["task"].frozen.state_dict().items():
        assert torch.equal(v, r["frozen_before"][k]), k


def test_test_metrics_match_jax(towers):
    """The test pass on the same true audio, parameters and predictions: the
    resynthesis goes through each package's forward kernel path; mel-L1 and
    MR-STFT are float32 transforms in both. Measured max relative 4.9e-6 (mel-L1,
    MR-STFT and their floors) and 1.8e-7 (parameter MAEs)."""
    jtask = _jax_downstream(towers, [])
    task = _port_downstream(towers, [])
    rng = np.random.RandomState(3)
    params01 = rng.rand(8, 78).astype(np.float32)
    pred = np.clip(params01 + 0.1 * rng.randn(8, 78), 0.0, 1.0).astype(np.float32)
    true_audio = np.array(jvoice.render_voice_fused(jax.numpy.asarray(params01), jtask.synth, True, None, jtask._noise))
    jm, _ = jtask._test_metrics_impl(
        jax.numpy.asarray(true_audio), jax.numpy.asarray(params01), jax.numpy.asarray(pred), jtask._noise
    )
    tm, pred_audio = task.test_metrics(torch.from_numpy(true_audio), torch.from_numpy(params01), torch.from_numpy(pred))
    jm = jax.device_get(jm)
    assert set(tm) == set(jm) and pred_audio.shape == true_audio.shape
    for key, ref in jm.items():
        got = tm[key].numpy()
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, err_msg=key)


def test_test_step_runs_with_floors(towers):
    task = _port_downstream(towers, ["audio_to_params.loss=param_mse"])
    state = task.init_state()
    metrics, true_audio, pred_audio = task.test_step(state, 99)
    assert true_audio.shape == pred_audio.shape == (8, 14400)
    assert torch.isfinite(pred_audio).all()
    assert 0.15 < float(metrics["audio_to_params/baseline/param_mae_const05"]) < 0.35
    for key in ("test/loss", "test/mel_l1", "test/mrstft", "test/param_mae", "baseline/mrstft_silence"):
        assert np.isfinite(float(metrics[f"audio_to_params/{key}"])), key
    assert metrics["audio_to_params/test/param_mae_per_param"].shape == (78,)


def test_mel_chunk_matches_unchunked(towers):
    """mel_chunk runs the grad-through-synth term in row chunks under activation
    checkpointing; chunks render with their own noise rows, so the loss and the
    update agree with the unchunked step up to the mean's association."""
    full = _port_downstream(towers, ["audio_to_params.loss=mel_l1"])
    chunked = _port_downstream(towers, ["audio_to_params.loss=mel_l1", "audio_to_params.mel_chunk=4"])
    s_f, s_c = full.init_state(), chunked.init_state()
    s_c.model.load_state_dict(s_f.model.state_dict())
    launches.reset()
    s_f, m_f = full.train_step(s_f, 17)
    s_c, m_c = chunked.train_step(s_c, 17)
    assert float(m_c["audio_to_params/train/loss"]) == pytest.approx(float(m_f["audio_to_params/train/loss"]), rel=1e-5)
    for (k, a), b in zip(s_f.model.state_dict().items(), s_c.model.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=5e-6, msg=k)
    bad = _port_downstream(towers, ["audio_to_params.loss=mel_l1", "audio_to_params.mel_chunk=3"])
    with pytest.raises(ValueError, match="mel_chunk"):
        bad.train_step(bad.init_state(), 17)
    rows = _port_downstream(towers, ["audio_to_params.loss=combined", "audio_to_params.mel_rows=4"])
    _, m = rows.train_step(rows.init_state(), 17)
    assert np.isfinite(float(m["audio_to_params/train/mel_l1"]))


def test_frozen_bn_batch_mode(towers):
    """frozen_bn=batch: the frozen towers normalize on the batch, deterministic
    (no dropout), and their running statistics stay as they were."""
    task = _port_downstream(towers, ["audio_to_params.frozen_bn=batch", "param_embed.dropout=0.1"])
    p = torch.rand(8, 78, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        e1, e2 = task._embed_params(p), task._embed_params(p)
    torch.testing.assert_close(e1, e2, rtol=0, atol=0)
    stats = {k: v.clone() for k, v in task.frozen.state_dict().items()}
    state = task.init_state()
    for i in range(2):
        state, metrics = task.train_step(state, 30 + i)
        assert np.isfinite(float(metrics["audio_to_params/train/loss"]))
    for k, v in task.frozen.state_dict().items():
        assert torch.equal(v, stats[k]), k
    with pytest.raises(ValueError):
        _port_downstream(towers, ["audio_to_params.frozen_bn=eval"])


def test_frozen_embedding_collapse_warning(towers, caplog):
    """The init-time probe warns when the frozen param embedding maps different
    parameter vectors to nearly the same point (all-zero towers), stays quiet on
    working towers, and is skipped when no embedding term is trained."""
    _, _, pre, state = towers
    collapsed = dataclasses.replace(state, model=copy.deepcopy(state.model))
    with torch.no_grad():
        for prm in collapsed.model.parameters():
            prm.zero_()
    cfg = load_config(overrides=SLICE + ["platform=cpu"])
    with caplog.at_level(logging.WARNING):
        caplog.clear()
        AudioToParamsTask(cfg, pre, collapsed)
        assert any("frozen projected-param-embedding" in r.message for r in caplog.records)
        caplog.clear()
        AudioToParamsTask(cfg, pre, state)
        assert not any("frozen projected-param-embedding" in r.message for r in caplog.records)
        caplog.clear()
        AudioToParamsTask(load_config(overrides=SLICE + ["platform=cpu", "audio_to_params.loss=param_mse"]),
                          pre, collapsed)
        assert not any("frozen projected-param-embedding" in r.message for r in caplog.records)


# -- checkpoints ----------------------------------------------------------------------


TINY = tiny_overrides(**{"param_embed.dropout": 0})


def test_checkpoint_round_trip_keep_and_last(tmp_path):
    task, state = _port_pretrain(TINY)
    state, _ = task.train_step(state, 3)
    ckpt = CheckpointManager(str(tmp_path / "ck"), every_n_steps=2, keep=3)
    for step in (2, 4, 6, 8):
        state.step = step
        assert ckpt.maybe_save(state, step)  # asynchronous
    assert not ckpt.maybe_save(state, 9)
    assert ckpt.latest_step() == 8  # waits for the write in flight
    assert (tmp_path / "ck" / "last").read_text() == "step_000000000008"
    assert sorted(p.name for p in (tmp_path / "ck").glob("step_*")) == [
        "step_000000000004", "step_000000000006", "step_000000000008"
    ]
    _, fresh = _port_pretrain(TINY)
    fresh = ckpt.restore(fresh)
    assert fresh.step == 8 and int(fresh.optimizer.count) == int(state.optimizer.count) == 1
    for (k, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    (tmp_path / "ck" / "last").unlink()  # no alias: the newest whole step directory
    (tmp_path / "ck" / "step_000000000010.tmp-1").mkdir()
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 8
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(fresh)


@pytest.mark.parametrize("broken", ["optimizer", "model"])
def test_failed_restore_leaves_the_state_untouched(tmp_path, broken):
    """A checkpoint whose optimizer part (loaded after the model) or one model
    tensor does not load: restore raises, and the fresh state keeps every one of
    its own values."""
    task, state = _port_pretrain(TINY)
    state, _ = task.train_step(state, 3)
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.save(state, 1)
    path = tmp_path / "ck" / "step_000000000001" / "state.pt"
    payload = torch.load(path, weights_only=True)
    if broken == "optimizer":
        del payload["optimizer"]["total_notfinite"]  # count loads, then the load fails
    else:
        key = next(k for k, v in payload["model"].items() if v.dim() == 2)
        payload["model"][key] = payload["model"][key][:, :1]  # the other tensors load
    torch.save(payload, path)
    _, fresh = _port_pretrain(TINY)
    before = {k: v.clone() for k, v in fresh.model.state_dict().items()}
    count_before = fresh.optimizer.count.clone()
    with pytest.raises((KeyError, RuntimeError)):
        ckpt.restore(fresh)
    assert fresh.step == 0 and torch.equal(fresh.optimizer.count, count_before)
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert any(not torch.equal(a, b) for a, b in zip(state.model.state_dict().values(), before.values()))


def test_trainer_resumes_from_checkpoint(tmp_path):
    """Four steps in one run equal two steps, a checkpoint, and two more steps
    resumed into a fresh state from it."""
    split = BatchNumberSplit(1000, 1, seed=0)
    task, state = _port_pretrain(TINY)
    Trainer(task, split, limit_train_batches=4, log_every=100).fit(state)

    ckpt_dir = str(tmp_path / "vicreg")
    task_a, state_a = _port_pretrain(TINY)
    Trainer(task_a, split, checkpoint=CheckpointManager(ckpt_dir, every_n_steps=1),
            limit_train_batches=2, log_every=100).fit(state_a)
    ckpt = CheckpointManager(ckpt_dir, every_n_steps=1)
    assert ckpt.latest_step() == 2
    task_b, state_b = _port_pretrain(TINY)
    state_b = ckpt.restore(state_b)
    state_b = Trainer(task_b, split, checkpoint=ckpt, limit_train_batches=4, log_every=100).fit(
        state_b, start_step=2
    )
    assert state_b.step == state.step == 4 and ckpt.latest_step() == 4
    for (k, a), b in zip(state.model.state_dict().items(), state_b.model.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)


# -- the CLIs -------------------------------------------------------------------------


def test_pretrain_then_downstream_cli_on_cpu(tmp_path):
    common = [a for a in tiny_overrides(**FUSED)] + [
        "platform=cpu", "log_every=1", f"run_dir={tmp_path}", "num_batches=100",
    ]
    env = {**os.environ, "OMP_NUM_THREADS": "2"}

    def run(module, extra):
        proc = subprocess.run(
            [sys.executable, "-m", f"inverse_audio_synthesis_tpu_torch.{module}", *common, *extra],
            cwd=REPO, capture_output=True, text=True, timeout=300, env=env,
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        return proc.stdout

    run("pretrain", ["vicreg.limit_train_batches=2"])
    assert (tmp_path / "checkpoints" / "vicreg" / "last").read_text() == "step_000000000002"
    out = run("downstream", ["audio_to_params.batch_size=8", "audio_to_params.limit_train_batches=2",
                             "audio_to_params.loss=combined"])
    assert "loaded vicreg checkpoint step 2" in out
    assert (tmp_path / "checkpoints" / "audio_to_params" / "last").read_text() == "step_000000000002"
    (csv,) = tmp_path.glob("downstream-torch-*/param_mae_per_param.csv")
    lines = csv.read_text().splitlines()
    assert lines[0] == "module,name,mae,mae_const05_baseline" and len(lines) == 79
    assert list(tmp_path.glob("downstream-torch-*/audio/*.wav"))


def test_downstream_cli_refuses_without_cuda_or_platform_cpu(monkeypatch, tmp_path):
    from inverse_audio_synthesis_tpu_torch import downstream

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="platform=cpu"):
        downstream.app(load_config(overrides=SLICE + [f"run_dir={tmp_path}"]))
