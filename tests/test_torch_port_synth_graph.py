"""The downstream train step's synth as a CUDA graph (``train/downstream.py``),
the graph helper under it (``ops/launches.py:CapturedGraph``) and the voice
source both training tasks hold (``synth/voice.py:VoiceSource``).

On a CUDA device ``AudioToParamsTask.train_step`` runs its synth eagerly once,
then captures it and replays the graph at every later step. The tests marked
``cuda`` hold the replay against the eager ``synthesize`` bit for bit, three
graphed train steps against three eager ones, the test pass's audio against a
later replay, and ``ops/render.py:launch_counts`` against the recorded launches;
and the helper's replays of a render with dropout from a registered generator
against the eager calls; they skip here. On the CPU: the task stays eager and
never captures, the device-key draw the graph reads its batch number through
equals the host draw at the downstream batch, and a pretraining and a downstream
task draw the same voices. This file imports neither JAX nor ``conftest``, so
the card runs it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_synth_graph.py
"""

import dataclasses
import logging

import pytest
import torch

from inverse_audio_synthesis_tpu_torch.models.layers import Dropout
from inverse_audio_synthesis_tpu_torch.ops import launches
from inverse_audio_synthesis_tpu_torch.ops import render as R
from inverse_audio_synthesis_tpu_torch.parallel.mesh import Mesh
from inverse_audio_synthesis_tpu_torch.synth import SynthConfig
from inverse_audio_synthesis_tpu_torch.synth.voice import VoiceSource, sample_voice_params
from inverse_audio_synthesis_tpu_torch.train import pretrain
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
    assert task.synth_path.startswith("cuda graph") and task.voices.fused_render
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
    assert not torch.equal(task._synth_graph.outputs[0][:, 0, :], true_audio)  # another batch there


@pytest.mark.cuda
def test_launch_counts_rise_by_the_recorded_count_at_each_replay(cuda_device):
    (task,) = _tasks("embedding")
    launches.reset()
    task._train_synth(3)
    assert R.launch_counts == {"render_fwd": 1, "render_bwd": 0}  # the eager synth's K1
    for n in BATCH_NUMS:
        before = dict(R.launch_counts)
        task._train_synth(n)
        recorded = task._synth_graph.launches
        assert R.launch_counts == {k: before[k] + recorded[k] for k in before}, n
    assert R.launch_counts == {"render_fwd": 1 + len(BATCH_NUMS), "render_bwd": 0}


@pytest.mark.cuda
def test_captured_graph_replays_are_the_eager_calls(cuda_device):
    """The helper on a render (one K1 launch) followed by dropout drawn from a
    registered generator: each replay equals the eager call with a generator of
    the same seed, bit for bit, and ``launch_counts`` rises by the recorded
    launches at each replay."""
    source = VoiceSource(SynthConfig(batch_size=4, buffer_size_seconds=1.0), cuda_device, slice(0, 4))
    drop = Dropout(0.5)
    gen_graph, gen_eager = (torch.Generator(device=cuda_device).manual_seed(11) for _ in range(2))

    def fn(batch_num):
        return drop(source(batch_num)[0])

    drop.generator = torch.Generator(device=cuda_device).manual_seed(5)
    fn(3)  # the render library is loaded outside the capture
    drop.generator = gen_graph
    graph = launches.CapturedGraph(fn, torch.zeros((), dtype=torch.int64, device=cuda_device), "a test graph",
                                   (gen_graph,))
    assert graph.launches == {**dict.fromkeys(graph.launches, 0), "render_fwd": 1}
    drop.generator = gen_eager
    for n in BATCH_NUMS:
        before = dict(R.launch_counts)
        out = graph.replay(n)
        assert out is graph.outputs
        assert R.launch_counts == {k: before[k] + graph.launches[k] for k in before}, n
        want = fn(torch.tensor(n, device=cuda_device))
        torch.cuda.synchronize()
        assert torch.equal(out, want), n


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
    """The graph's draw (a tensor batch number and the task's ``seed_key``)
    against the host draw, bit for bit, at batch 1024 (the shipped
    ``audio_to_params.batch_size``), and through the task's ``synthesize``."""
    (task,) = _tasks("param_mse", extra=["platform=cpu", f"seed={seed}"])
    shipped = dataclasses.replace(task.synth, batch_size=1024)
    for n in (0,) + BATCH_NUMS:
        want = sample_voice_params(n, shipped)
        got = sample_voice_params(torch.tensor(n, dtype=torch.int64), shipped, seed_key=task.voices.seed_key)
        assert want.shape == (1024, 78) and torch.equal(got, want), n
    audio, params01 = task.synthesize(BATCH_NUMS[-1])
    audio_t, params01_t = task.synthesize(torch.tensor(BATCH_NUMS[-1]))
    assert torch.equal(params01_t, params01) and torch.equal(audio_t, audio)


@pytest.mark.parametrize("rank", [None, 1])
def test_pretraining_and_downstream_tasks_draw_the_same_voices(monkeypatch, rank):
    """A pretraining and a downstream task of one seed and batch size give the
    same bits for a batch number: the whole batch, and (``rank=1``) the second
    half of it, as rank 1 of two data ranks holds it, with the whole batch's
    parameters and noise rows of those positions."""
    cpu = FUSED + ["platform=cpu", "audio_to_params.loss=param_mse"]
    whole = VoiceSource(pretrain.synth_config_from_cfg(load_config(overrides=cpu), 8), "cpu", slice(0, 8))
    if rank is not None:
        monkeypatch.setattr(pretrain, "mesh_from_cfg", lambda cfg: Mesh(data=2, data_index=rank))
    vicreg = VicregPretrainTask(load_config(overrides=cpu))
    downstream = AudioToParamsTask(load_config(overrides=cpu), vicreg, vicreg.init_state())
    rows = slice(0, 8) if rank is None else slice(4, 8)
    assert vicreg.rows == downstream.rows == rows
    assert torch.equal(vicreg.voices.noise, downstream.voices.noise)
    assert torch.equal(vicreg.voices.noise, whole.noise[rows])
    for n in BATCH_NUMS:
        audio, params01 = vicreg.synthesize(n)
        audio_d, params01_d = downstream.synthesize(n)
        assert audio.shape == (rows.stop - rows.start, 1, 14400), n
        assert torch.equal(params01_d, params01) and torch.equal(audio_d, audio), n
        assert torch.equal(params01, sample_voice_params(n, whole.config)[rows]), n
