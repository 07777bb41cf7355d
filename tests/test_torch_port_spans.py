"""The port's spans (``utils/profiling.py:span``): the training loop's and
step's phases and the retrieval sub-chunk's stages are ``record_function``
ranges under a profiler, in order and nested, and nothing at all without one;
a profiler changes no number the steps compute."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import tiny_overrides
from inverse_audio_synthesis_tpu_torch.eval.retrieval import RetrievalEvaluator
from inverse_audio_synthesis_tpu_torch.train.downstream import AudioToParamsTask
from inverse_audio_synthesis_tpu_torch.train.loop import Trainer
from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask, synth_config_from_cfg
from inverse_audio_synthesis_tpu_torch.train.runsetup import BatchNumberSplit
from inverse_audio_synthesis_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

TINY = tiny_overrides(**{"param_embed.dropout": 0.1}) + ["platform=cpu"]
# the fused render's geometry (its plain version on the CPU), so combined runs K1's and K2's arithmetic
FUSED = tiny_overrides(**{"image.height": 60, "image.width": 80,
                          "torchsynth.buffer_size_seconds": 14400 / 44100,
                          "audio_to_params.batch_size": 8}) + ["platform=cpu"]
PHASES = ["step/synth", "step/forward", "step/backward", "step/optimizer"]
RETRIEVAL = ["retrieval/render", "retrieval/embed", "retrieval/cdist", "retrieval/update"]


def _pretrain():
    task = VicregPretrainTask(load_config(overrides=TINY))
    return task, task.init_state()


def _downstream(loss="combined"):
    pretrain = VicregPretrainTask(load_config(overrides=FUSED))
    task = AudioToParamsTask(load_config(overrides=FUSED + [f"audio_to_params.loss={loss}"]),
                             pretrain, pretrain.init_state())
    return task, task.init_state()


def _retrieval():
    cfg = load_config(overrides=TINY)
    t = synth_config_from_cfg(cfg, 4).buffer_size
    w = torch.from_numpy((np.random.RandomState(1).randn(t, 16) / np.sqrt(t)).astype(np.float32))
    return RetrievalEvaluator(lambda a: a[:, 0, :] @ w, synth_config_from_cfg(cfg, 4),
                              synth_config_from_cfg(cfg, 8), inner_chunk=4, device="cpu")


def _profiled(work):
    """The spans (start, end, name) that ``work()`` records under a started
    profiler, in order of start."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        work()
    finally:
        prof.stop()
    names = ("step/", "loop/", "retrieval/")
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.name.startswith(names))


def _within(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("work", ["pretrain", "downstream", "fit", "retrieval"])
def test_no_record_function_is_entered_without_a_profiler(monkeypatch, work):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    if work == "pretrain":
        task, state = _pretrain()
        task.train_step(state, 3)
    elif work == "downstream":
        task, state = _downstream()
        task.train_step(state, 3)
    elif work == "fit":
        task, state = _pretrain()
        Trainer(task, BatchNumberSplit(1000, 1, seed=0), limit_train_batches=2, log_every=1).fit(state)
    else:
        _retrieval().step(2)


@pytest.mark.parametrize("make", [_pretrain, _downstream], ids=["pretrain", "downstream_combined"])
def test_an_eager_step_records_its_four_phases_once_in_order(make):
    task, state = make()
    task.train_step(state, 3)  # lazy set-up outside the profile
    spans = _profiled(lambda: task.train_step(state, 4))
    assert [n for _, _, n in spans] == PHASES
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))  # one after the other


def test_fit_nests_the_steps_in_loop_iterations_and_logs_at_log_steps():
    task, state = _pretrain()
    trainer = Trainer(task, BatchNumberSplit(1000, 1, seed=0), limit_train_batches=5, log_every=2)
    spans = _profiled(lambda: trainer.fit(state))
    iterations = [s for s in spans if s[2] == "loop/iteration"]
    assert len(iterations) == 5
    for s in spans:
        if s[2] != "loop/iteration":
            assert sum(_within(s, it) for it in iterations) == 1, s
    for it in iterations:
        inside = [s[2] for s in spans if s is not it and _within(s, it)]
        assert inside[:4] == PHASES
    # logged after the first step and at each multiple of log_every: steps 0, 1 and 3
    logged = [i for i, it in enumerate(iterations) if any(s[2] == "loop/log" and _within(s, it) for s in spans)]
    assert logged == [0, 1, 3]
    assert not any(s[2] in ("loop/validate", "loop/checkpoint") for s in spans)  # neither is configured


def test_retrieval_records_its_four_stages_per_sub_chunk():
    """(Without a profiler they are not entered: the first test's retrieval case.)"""
    evaluator = _retrieval()
    spans = _profiled(lambda: evaluator.step(2))
    assert [n for _, _, n in spans] == RETRIEVAL * 2  # two sub-chunks of 4 candidates


@pytest.mark.parametrize("make", [_pretrain, _downstream], ids=["pretrain", "downstream_combined"])
def test_a_profiler_changes_no_loss_and_no_parameter(make):
    def three_steps(profiled: bool):
        task, state = make()
        losses = []

        def run():
            nonlocal state
            for n in (5, 6, 7):
                state, metrics = task.train_step(state, n)
                losses.append(metrics[next(k for k in metrics if k.endswith("train/loss"))])

        if profiled:
            _profiled(run)
        else:
            run()
        return torch.stack(losses), [p.detach().clone() for p in state.model.parameters()]

    off, on = three_steps(False), three_steps(True)
    assert torch.equal(off[0], on[0])
    assert all(torch.equal(a, b) for a, b in zip(off[1], on[1]))
