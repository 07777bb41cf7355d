"""Downstream inverse-synthesis CLI of the PyTorch port.

    python -m inverse_audio_synthesis_tpu_torch.downstream [vicreg_checkpoint=<dir>] \
        [audio_to_params.loss=combined] ... [platform=cpu]

Same config keys and overrides as the JAX package's ``downstream.py``. Loads the
VICReg checkpoint (``vicreg_checkpoint``, default ``<run_dir>/checkpoints/vicreg``,
as the port's ``pretrain`` CLI writes it), or warns and uses random towers; trains
the head with checkpoints under ``<run_dir>/checkpoints/audio_to_params`` and
resumes from them when rerun; then runs the test pass, reports each metric's mean
and std over the test batches and writes the per-parameter MAE as a CSV. Runs on
the CUDA device, where each train step after the first replays a CUDA graph
of its synth (``train/downstream.py``; the counts are printed after training);
``platform=cpu`` runs on the CPU. ``steps_per_dispatch=k`` hands
the loop's dispatches of up to k steps to the task, which runs them in order;
``profile_dir=<dir>`` writes a ``torch.profiler`` trace of the whole fit there;
the run config carries the git commit. Under ``torchrun`` each process
is a rank of the ``mesh.data`` x ``mesh.model`` mesh; rank 0 alone prints, logs
and writes files, from the global batch's metrics.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from inverse_audio_synthesis_tpu_torch.parallel.launch import is_main_process
from inverse_audio_synthesis_tpu_torch.pretrain import (
    fit_maybe_traced,
    make_logger,
    restore_latest,
    run_cli,
)
from inverse_audio_synthesis_tpu_torch.synth.voice import VOICE_PARAM_SPECS
from inverse_audio_synthesis_tpu_torch.train.checkpoint import CheckpointManager
from inverse_audio_synthesis_tpu_torch.train.downstream import AudioToParamsTask
from inverse_audio_synthesis_tpu_torch.train.loop import Trainer
from inverse_audio_synthesis_tpu_torch.train.pretrain import restore_vicreg
from inverse_audio_synthesis_tpu_torch.train.runsetup import runsetup


def evaluate_test_split(task: AudioToParamsTask, state, split, logger) -> Path:
    """Every test batch through ``test_step``; logs each batch's scalars and audio,
    the mean and std over batches, and writes the per-parameter MAE CSV. Every
    rank runs the test steps; the one with ``logger`` (rank 0) reports."""
    per_param, per_param_base, scalar_rows = [], [], []
    for i in range(split.sizes.test):
        metrics, true_audio, pred_audio = task.test_step(state, split.test_batch_num(i))
        per_param.append(metrics.pop("audio_to_params/test/param_mae_per_param").cpu().numpy())
        per_param_base.append(
            metrics.pop("audio_to_params/baseline/param_mae_per_param_const05").cpu().numpy()
        )
        scalars = {k: float(v) for k, v in metrics.items()}
        scalar_rows.append(scalars)
        if logger is not None:
            logger.log(scalars)
            task.log_audio_triplets(logger, true_audio, pred_audio, batch_idx=i)
    if logger is None:
        return None
    if len(scalar_rows) > 1:
        summary = {}
        for k in scalar_rows[0]:
            vals = np.asarray([r[k] for r in scalar_rows])
            summary[f"{k}/mean"] = float(vals.mean())
            summary[f"{k}/std"] = float(vals.std(ddof=1))
        logger.log(summary)
        print(f"test metrics over {len(scalar_rows)} batches (mean ± std):")
        for k in scalar_rows[0]:
            print(f"  {k}: {summary[f'{k}/mean']:.4f} ± {summary[f'{k}/std']:.4f}")
    else:
        print("test metrics (one batch; set ntest_batches >= 2 for error bars):")
        for k, v in scalar_rows[0].items():
            print(f"  {k}: {v:.4f}")
    mae = np.mean(per_param, axis=0)
    base = np.mean(per_param_base, axis=0)
    csv_path = Path(logger.dir) / "param_mae_per_param.csv"
    with open(csv_path, "w") as f:
        f.write("module,name,mae,mae_const05_baseline\n")
        for spec, m, b in zip(VOICE_PARAM_SPECS, mae, base):
            f.write(f"{spec.module},{spec.name},{m:.6f},{b:.6f}\n")
    print(f"per-param MAE written to {csv_path}")
    print(f"params below their chance floor: {int(np.sum(mae < base))}/{len(mae)}")
    print("best-learned params:")
    for j in np.argsort(mae)[:8]:
        s = VOICE_PARAM_SPECS[j]
        print(f"  {s.module}.{s.name}: {mae[j]:.4f} (chance {base[j]:.4f})")
    return csv_path


def app(cfg) -> int:
    split = runsetup(cfg)
    run_dir = Path(cfg.get("run_dir", "runs"))
    pretrain_task, vicreg_state, step = restore_vicreg(cfg)
    device = pretrain_task.device
    main = is_main_process()
    if main:
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        print(f"device: {device} ({name}); mesh data={pretrain_task.mesh.data} "
              f"model={pretrain_task.mesh.model}")
        if step is not None:
            print(f"loaded vicreg checkpoint step {step}")
        else:
            print("WARNING: no vicreg checkpoint found; using random towers")

    task = AudioToParamsTask(cfg, pretrain_task, vicreg_state)
    del pretrain_task, vicreg_state  # the task keeps its own frozen copy
    state = task.init_state()
    if main:
        print(f"objective: {task.loss_kind}; render backward: {task.render_bwd}; render: "
              f"{'fused' if task.voices.fused_render else 'portable render_voice'}; train step synth: "
              f"{task.synth_path}; optimizer: {state.optimizer.path}")

    logger = make_logger(cfg, run_dir, "downstream")
    checkpoint = CheckpointManager(
        directory=str(run_dir / "checkpoints" / "audio_to_params"),
        every_n_steps=cfg.audio_to_params.checkpoint_every_nbatches,
        mesh=task.mesh,
    )
    trainer = Trainer(
        task,
        split,
        logger=logger,
        checkpoint=checkpoint,
        limit_train_batches=cfg.audio_to_params.get("limit_train_batches"),
        log_every=cfg.get("log_every", 50),
        steps_per_dispatch=cfg.get("steps_per_dispatch", 1),
    )
    state, start = restore_latest(checkpoint, state, "downstream")
    try:
        state = fit_maybe_traced(cfg, trainer, state, start, device)
        if main:
            print(f"train step synths: {task.synth_calls['replayed']} graph replays, "
                  f"{task.synth_calls['eager']} eager")
        if trainer.interrupted is not None:
            # no test pass over a half-trained head; rerunning resumes
            if main:
                print(f"stopped by signal {trainer.interrupted}; checkpoint saved")
            return 75
        evaluate_test_split(task, state, split, logger)
    finally:
        if logger is not None:
            logger.finish()
    if main:
        print(f"metrics written to {logger.dir}")
    return 0


if __name__ == "__main__":
    sys.exit(run_cli(app, sys.argv[1:]))
