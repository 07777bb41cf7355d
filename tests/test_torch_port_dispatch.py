"""``steps_per_dispatch``, ``detect_anomaly`` and ``profile_dir`` in the port.

- The loop's dispatch lengths against the JAX ``Trainer._dispatch_len``.
- k = 4 against k = 1 on the CPU loop path (``tests/test_loop.py:146``): the same
  logged steps, checkpoints and parameters, for pretraining and downstream; a
  signal during a dispatch stops the loop at the dispatch's end.
- The device-key draw the CUDA graph reads its batch numbers through, against
  the host draw, bit for bit.
- A NaN injected into one step: raised at the backward op in anomaly mode,
  rejected and counted with ``detect_anomaly`` off.
- The pretrain CLI with ``profile_dir`` and the downstream CLI with
  ``steps_per_dispatch=2``.
"""

import itertools
import json
import os
import signal
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import tiny_overrides
from inverse_audio_synthesis_tpu.train.loop import Trainer as JTrainer
from inverse_audio_synthesis_tpu_torch.synth.config import SynthConfig
from inverse_audio_synthesis_tpu_torch.synth.voice import sample_voice_params
from inverse_audio_synthesis_tpu_torch.train.checkpoint import CheckpointManager
from inverse_audio_synthesis_tpu_torch.train.downstream import AudioToParamsTask
from inverse_audio_synthesis_tpu_torch.train.loop import Trainer
from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask
from inverse_audio_synthesis_tpu_torch.train.runsetup import BatchNumberSplit
from inverse_audio_synthesis_tpu_torch.utils.config import load_config
from inverse_audio_synthesis_tpu_torch.utils.profiling import nan_debugging

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = tiny_overrides(**{"param_embed.dropout": 0.1})
FUSED = tiny_overrides(**{"image.height": 60, "image.width": 80,
                          "torchsynth.buffer_size_seconds": 14400 / 44100,
                          "audio_to_params.batch_size": 8})


class _Rows:
    def __init__(self):
        self.rows = []

    def log(self, metrics, step=None):
        self.rows.append((step, metrics))


def _task(overrides=TINY):
    return VicregPretrainTask(load_config(overrides=list(overrides) + ["platform=cpu"]))


# -- the dispatch lengths -------------------------------------------------------------


def test_dispatch_len_matches_jax():
    grid = itertools.product(range(0, 13), (0, 3), (7, 12), (1, 4, 5), (None, 3, 6), (None, 4), (1, 2, 3, 8))
    checked = 0
    for i, start, n, log, val, ckpt, k in grid:
        if i < start or i >= n:
            continue
        kw = dict(log_every=log, val_check_interval=val, steps_per_dispatch=k,
                  checkpoint=SimpleNamespace(every_n_steps=ckpt) if ckpt else None)
        want = JTrainer(None, None, **kw)._dispatch_len(i, n, start)
        assert Trainer(None, None, **kw)._dispatch_len(i, n, start) == want, (i, start, n, log, val, ckpt, k)
        checked += 1
    assert checked > 2000


# -- k = 4 against k = 1 on the CPU path ---------------------------------------------


def _pretrain_run(tmp_path, k):
    task = _task()
    state = task.init_state()
    rows = _Rows()
    ckpt = CheckpointManager(str(tmp_path / f"k{k}"), every_n_steps=3, keep=10)
    trainer = Trainer(task, BatchNumberSplit(1000, 1, seed=0), logger=rows, checkpoint=ckpt,
                      limit_train_batches=10, limit_val_batches=1, val_check_interval=5, log_every=2,
                      steps_per_dispatch=k)
    state = trainer.fit(state)
    return task, state, rows.rows, ckpt


def test_steps_per_dispatch_matches_one_step_dispatches(tmp_path):
    """Pretraining, dropout 0.1: the same logged steps and values, validation
    steps, checkpoints on disk and final parameters."""
    _, s1, rows1, ck1 = _pretrain_run(tmp_path, 1)
    task4, s4, rows4, ck4 = _pretrain_run(tmp_path, 4)
    assert task4.dispatch_path.startswith("eager") and "CPU" in task4.dispatch_path
    assert [s for s, _ in rows1] == [s for s, _ in rows4]
    assert [s for s, m in rows4 if "vicreg/train/loss" in m] == [0, 1, 3, 5, 7, 9]
    for (_, a), (_, b) in zip(rows1, rows4):
        for key in a:
            if key not in ("steps_per_sec", "voices_per_sec"):
                assert a[key] == b[key], key
    assert ck1._steps_on_disk() == ck4._steps_on_disk() == [3, 6, 9, 10]
    assert s1.step == s4.step == 10 and int(s1.optimizer.count) == int(s4.optimizer.count) == 10
    for (key, a), b in zip(s1.model.state_dict().items(), s4.model.state_dict().values()):
        assert torch.equal(a, b), key


def test_a_signal_stops_at_the_dispatch_boundary(tmp_path):
    """SIGTERM during the second dispatch (steps 1-3 of k = 4): the dispatch
    finishes, a checkpoint of step 4 is written and fit returns, interrupted."""
    task = _task()
    state = task.init_state()
    multi = task.train_step_multi

    def signalled(s, nums):
        if nums[0] == trainer.split.train_batch_num(1):
            os.kill(os.getpid(), signal.SIGTERM)
        return multi(s, nums)

    task.train_step_multi = signalled
    ckpt = CheckpointManager(str(tmp_path), every_n_steps=100)
    trainer = Trainer(task, BatchNumberSplit(1000, 1, seed=0), checkpoint=ckpt, limit_train_batches=12,
                      log_every=4, steps_per_dispatch=4)
    state = trainer.fit(state)
    assert trainer.interrupted == signal.SIGTERM
    assert state.step == 4 and ckpt.latest_step() == 4


def test_train_step_multi_stacks_the_steps_metrics():
    task = _task()
    s1 = task.init_state()
    seq = []
    for n in (5, 6, 7):
        s1, m = task.train_step(s1, n)
        seq.append(m)
    s3, stacked = task.train_step_multi(task.init_state(), [5, 6, 7])
    assert s3.step == 3 and set(stacked) == set(seq[0])
    for key, v in stacked.items():
        assert v.shape == (3,)
        assert torch.equal(v, torch.stack([m[key] for m in seq])), key


def test_downstream_steps_per_dispatch_matches_one_step_dispatches(tmp_path):
    pretrain = VicregPretrainTask(load_config(overrides=FUSED + ["platform=cpu"]))
    vicreg_state = pretrain.init_state()
    out = {}
    for k in (1, 2):
        cfg = load_config(overrides=FUSED + ["platform=cpu", "audio_to_params.loss=combined"])
        task = AudioToParamsTask(cfg, pretrain, vicreg_state)
        state = task.init_state()
        rows = _Rows()
        ckpt = CheckpointManager(str(tmp_path / f"k{k}"), every_n_steps=2, keep=10)
        state = Trainer(task, BatchNumberSplit(1000, 1, seed=0), logger=rows, checkpoint=ckpt,
                        limit_train_batches=5, log_every=4, steps_per_dispatch=k).fit(state)
        out[k] = (state, rows.rows, ckpt._steps_on_disk())
    (s1, r1, c1), (s2, r2, c2) = out[1], out[2]
    assert [s for s, _ in r1] == [s for s, _ in r2] == [0, 3] and c1 == c2 == [2, 4, 5]
    assert r1[1][1]["audio_to_params/train/loss"] == r2[1][1]["audio_to_params/train/loss"]
    for a, b in zip(s1.model.state_dict().values(), s2.model.state_dict().values()):
        assert torch.equal(a, b)


# -- the device-key draw --------------------------------------------------------------


@pytest.mark.parametrize("batch_size", [4, 16])
def test_device_key_draw_matches_the_host_draw(batch_size):
    """The graph path's draw (batch number and seed key as tensor data) against
    sample_voice_params through the host key, bit for bit, and through the task."""
    cfg = SynthConfig(batch_size=batch_size, seed=42)
    seed_key = torch.tensor([0, 42], dtype=torch.int64)
    for n in (0, 1, 7, 9_999_999, 49_999_999, 2**31 - 1):
        want = sample_voice_params(n, cfg)
        got = sample_voice_params(torch.tensor(n, dtype=torch.int64), cfg, seed_key=seed_key)
        assert torch.equal(got, want), n
    task = _task()
    a, p = task.synthesize(123)
    b, q = task.synthesize(torch.tensor(123))
    assert torch.equal(p, q) and torch.equal(a, b)


# -- a NaN in one step ----------------------------------------------------------------


def _poison(task, at_call: int):
    """Make the loss of the ``at_call``-th train step NaN (a NaN times the loss:
    the forward and the BatchNorm statistics stay finite, every gradient is NaN)."""
    losses, calls = task._losses, []

    def poisoned(x, y):
        out = losses(x, y)
        calls.append(1)
        if len(calls) == at_call:
            return (out[0] * float("nan"),) + tuple(out[1:])
        return out

    task._losses = poisoned


def test_detect_anomaly_raises_at_the_backward_op():
    with nan_debugging():
        task = _task(TINY + ["detect_anomaly=true"])
        assert task.dispatch_path.startswith("eager") and torch.is_anomaly_enabled()
        state = task.init_state()
        _poison(task, 2)
        state, _ = task.train_step(state, 0)
        with pytest.raises(RuntimeError, match=r"Function '\w+Backward\d*' returned nan values"):
            task.train_step_multi(state, [1, 2])
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("detect_anomaly", [False, True])
def test_a_nonfinite_step_is_rejected_and_counted(detect_anomaly):
    """detect_anomaly off: the poisoned step is rejected on the device, counted
    and logged, and training goes on; on (the default): the loop raises at the
    next log."""
    task = _task()
    state = task.init_state()
    _poison(task, 2)
    rows = _Rows()
    trainer = Trainer(task, BatchNumberSplit(1000, 1, seed=0), logger=rows, limit_train_batches=4,
                      log_every=2, detect_anomaly=detect_anomaly, steps_per_dispatch=2)
    if detect_anomaly:
        with pytest.raises(FloatingPointError, match="notfinite_steps"):
            trainer.fit(state)
        return
    state = trainer.fit(state)
    logged = dict(rows.rows)
    assert logged[1]["notfinite_steps"] == 1 and np.isnan(logged[1]["vicreg/train/loss"])
    assert logged[3]["notfinite_steps"] == 1 and np.isfinite(logged[3]["vicreg/train/loss"])
    assert state.step == 4 and int(state.optimizer.count) == 3 and int(state.optimizer.total_notfinite) == 1


# -- the CLIs -------------------------------------------------------------------------


def _cli(module, args, cwd):
    proc = subprocess.run([sys.executable, "-m", f"inverse_audio_synthesis_tpu_torch.{module}", *args],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_pretrain_cli_profile_dir_summary_filter_range_and_git_sha(tmp_path):
    out = _cli("pretrain", TINY + ["platform=cpu", "vicreg.limit_train_batches=2", "log_every=1",
                                   f"run_dir={tmp_path}", "num_batches=100", f"profile_dir={tmp_path}/prof",
                                   "steps_per_dispatch=2"], REPO)
    assert f"profiler trace written to {tmp_path}/prof" in out
    (trace,) = (tmp_path / "prof").glob("trace-*.json")
    assert json.loads(trace.read_text())["traceEvents"]
    assert "projector/lin_final" in out and "TOTAL" in out
    (run,) = tmp_path.glob("pretrain-torch-*")
    lines = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    bands = {k for line in lines for k in line if k.startswith("pqmf/band")}
    assert bands == {f"pqmf/band{i}/{s}" for i in range(3) for s in ("min", "max", "rms")}
    config = json.loads((run / "config.json").read_text())
    assert "git_sha" in config and config["profile_dir"] == f"{tmp_path}/prof"
    assert (tmp_path / "checkpoints" / "vicreg" / "last").read_text() == "step_000000000002"


def test_downstream_cli_steps_per_dispatch(tmp_path):
    """No VICReg checkpoint (random towers): three head steps two at a time end
    at the checkpoint step of one at a time, with a trace of the fit."""
    _cli("downstream", FUSED + ["platform=cpu", "log_every=2", f"run_dir={tmp_path}", "num_batches=100",
                                "audio_to_params.limit_train_batches=3", "steps_per_dispatch=2",
                                f"profile_dir={tmp_path}/prof"], REPO)
    assert (tmp_path / "checkpoints" / "audio_to_params" / "last").read_text() == "step_000000000003"
    assert list((tmp_path / "prof").glob("trace-*.json"))
    (run,) = tmp_path.glob("downstream-torch-*")
    assert "git_sha" in json.loads((run / "config.json").read_text())
