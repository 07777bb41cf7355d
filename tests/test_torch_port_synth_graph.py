"""The downstream train step's synth as a CUDA graph (``train/downstream.py``).

On a CUDA device ``AudioToParamsTask.train_step`` runs its synth eagerly once,
then captures it and replays the graph at every later step. The tests marked
``cuda`` hold the replay against the eager ``synthesize`` bit for bit, three
graphed train steps against three eager ones, the test pass's audio against a
later replay, and ``ops/render.py:launch_counts`` against the recorded launches;
they skip here. On the CPU: the task stays eager and never captures, and the
device-key draw the graph reads its batch number through equals the host draw
at the downstream batch. This file imports neither JAX nor ``conftest``, so the
card runs it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_synth_graph.py
"""

import dataclasses
import logging

import pytest
import torch

from inverse_audio_synthesis_tpu_torch.ops import render as R
from inverse_audio_synthesis_tpu_torch.synth.voice import sample_voice_params
from inverse_audio_synthesis_tpu_torch.train.downstream import AudioToParamsTask
from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask
from inverse_audio_synthesis_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

# the tiny test widths with a 3 x 60 x 80 pseudo-image (14,400 samples, 144
# control steps, ratio 100), which the fused render takes
FUSED = ["vicreg=fast", "dim=32", "embeddim=64", "vicreg.mlp='64-%d'", "vicreg.batch_size=8",
         "image.height=60", "image.width=80", f"torchsynth.buffer_size_seconds={14400 / 44100}",
         "precision=f32", "audio_to_params.batch_size=8"]
BATCH_NUMS = (5, 17, 2**31 + 11)


def _tasks(*losses, extra=()):
    """One downstream task per objective, on the same frozen towers."""
    extra = list(extra)
    pretrain = VicregPretrainTask(load_config(overrides=FUSED + extra))
    towers = pretrain.init_state()
    return [AudioToParamsTask(load_config(overrides=FUSED + extra + [f"audio_to_params.loss={loss}"]),
                              pretrain, towers) for loss in losses]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the synth graph is captured only on a card")
    return torch.device("cuda")


# -- on the card --------------------------------------------------------------------


@pytest.mark.cuda
def test_graphed_synth_is_the_eager_synth_bit_for_bit(cuda_device):
    (task,) = _tasks("embedding")
    assert task.synth_path.startswith("cuda graph") and task.fused_render
    task._train_synth(3)  # the first runs eagerly
    assert task._synth_graph is None
    for n in BATCH_NUMS:
        audio, params01 = task._train_synth(n)
        want_audio, want_params = task.synthesize(n)
        torch.cuda.synchronize()
        assert torch.equal(params01, want_params), n
        assert torch.equal(audio, want_audio), n
    assert task.synth_calls == {"replayed": len(BATCH_NUMS), "eager": 1}
    # the capture recorded one K1 launch and none of any other kernel (the
    # recording covers every kernel module, ops/launches.py)
    assert task._synth_graph.launches == {**dict.fromkeys(task._synth_graph.launches, 0), "render_fwd": 1}
    assert task._synth_graph.launches["render_bwd"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["embedding", "combined"])
def test_graphed_train_steps_give_the_eager_steps(cuda_device, loss):
    """Three train steps with the synth graphed against three eager ones (dropout
    on: the graph draws nothing from the head's generator)."""
    graphed, eager = _tasks(loss, loss)
    eager._graph_synth = False
    runs = []
    for task in (graphed, eager):
        state = task.init_state()
        losses = []
        for n in BATCH_NUMS:
            state, metrics = task.train_step(state, n)
            losses.append(metrics["audio_to_params/train/loss"])
        runs.append((torch.stack(losses).cpu(), {k: v.cpu() for k, v in state.model.state_dict().items()}))
    assert graphed.synth_calls == {"replayed": 2, "eager": 1}
    assert eager.synth_calls == {"replayed": 0, "eager": 3} and eager._synth_graph is None
    (loss_g, params_g), (loss_e, params_e) = runs
    assert torch.equal(loss_g, loss_e), (loss_g, loss_e)
    for key, value in params_e.items():
        assert torch.equal(params_g[key], value), key


@pytest.mark.cuda
def test_test_step_audio_is_unchanged_by_a_later_train_step(cuda_device):
    (task,) = _tasks("param_mse")
    state = task.init_state()
    for n in BATCH_NUMS[:2]:  # eager, then captured and replayed
        state, _ = task.train_step(state, n)
    _, true_audio, pred_audio = task.test_step(state, 99)
    kept = true_audio.clone(), pred_audio.clone()
    state, _ = task.train_step(state, BATCH_NUMS[2])  # a replay overwrites the graph's buffers
    torch.cuda.synchronize()
    assert task.synth_calls["replayed"] == 2
    assert torch.equal(true_audio, kept[0]) and torch.equal(pred_audio, kept[1])
    assert not torch.equal(task._synth_graph.out[0][:, 0, :], true_audio)  # another batch there


@pytest.mark.cuda
def test_launch_counts_rise_by_the_recorded_count_at_each_replay(cuda_device):
    (task,) = _tasks("embedding")
    R.reset_launch_counts()
    task._train_synth(3)
    assert R.launch_counts == {"render_fwd": 1, "render_bwd": 0}  # the eager synth's K1
    for n in BATCH_NUMS:
        before = dict(R.launch_counts)
        task._train_synth(n)
        recorded = task._synth_graph.launches
        assert R.launch_counts == {k: before[k] + recorded[k] for k in before}, n
    assert R.launch_counts == {"render_fwd": 1 + len(BATCH_NUMS), "render_bwd": 0}


# -- on the CPU ---------------------------------------------------------------------


def test_a_cpu_task_runs_its_synth_eagerly_and_logs_the_path(monkeypatch, caplog):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU task captured a CUDA graph")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    with caplog.at_level(logging.INFO, logger="inverse_audio_synthesis_tpu_torch.train.downstream"):
        (task,) = _tasks("param_mse", extra=["platform=cpu"])
    assert task.synth_path == "eager: a CPU run"
    assert [r.getMessage() for r in caplog.records if "synth path" in r.getMessage()] == [
        "train step synth path: eager: a CPU run"]
    state = task.init_state()
    for n in BATCH_NUMS:
        state, _ = task.train_step(state, n)
    assert task.synth_calls == {"replayed": 0, "eager": len(BATCH_NUMS)} and task._synth_graph is None


@pytest.mark.parametrize("seed", [0, 2**31 + 12345])
def test_device_key_draw_matches_the_host_draw_at_the_downstream_batch(seed):
    """The graph's draw (a tensor batch number and the task's ``_seed_key``)
    against the host draw, bit for bit, at batch 1024 (the shipped
    ``audio_to_params.batch_size``), and through the task's ``synthesize``."""
    (task,) = _tasks("param_mse", extra=["platform=cpu", f"seed={seed}"])
    shipped = dataclasses.replace(task.synth, batch_size=1024)
    for n in (0,) + BATCH_NUMS:
        want = sample_voice_params(n, shipped)
        got = sample_voice_params(torch.tensor(n, dtype=torch.int64), shipped, seed_key=task._seed_key)
        assert want.shape == (1024, 78) and torch.equal(got, want), n
    audio, params01 = task.synthesize(BATCH_NUMS[-1])
    audio_t, params01_t = task.synthesize(torch.tensor(BATCH_NUMS[-1]))
    assert torch.equal(params01_t, params01) and torch.equal(audio_t, audio)
