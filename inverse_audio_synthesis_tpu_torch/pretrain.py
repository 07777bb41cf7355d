"""VICReg pretraining CLI of the PyTorch port.

    python -m inverse_audio_synthesis_tpu_torch.pretrain [vicreg=fast] [dim=64] ... [platform=cpu]

Same config keys and overrides as the JAX package's ``pretrain.py``. Runs on the
CUDA device; ``platform=cpu`` runs on the CPU. Prints the parameter summary, logs
the PQMF filter range of the vendored clip and the git commit in the run config,
saves checkpoints under ``<run_dir>/checkpoints/vicreg`` every
``vicreg.checkpoint_every_nbatches`` steps and at the end, and resumes from the
latest one when rerun. ``steps_per_dispatch=k`` runs k steps per dispatch (one
CUDA graph on the card: ``train/pretrain.py``); ``detect_anomaly=true`` turns on
torch's anomaly mode before the task is built; ``profile_dir=<dir>`` writes a
``torch.profiler`` trace of the whole fit there.

Under ``torchrun`` each process is a rank of the ``mesh.data`` x ``mesh.model``
mesh (``parallel/launch.py`` picks NCCL or gloo and prints it); rank 0 alone
prints, logs and writes checkpoints:

    torchrun --nproc-per-node 2 -m inverse_audio_synthesis_tpu_torch.pretrain mesh.data=2 platform=cpu ...
"""

from __future__ import annotations

import contextlib
import sys
import time
from pathlib import Path

import torch

from inverse_audio_synthesis_tpu_torch.parallel.launch import finish, init_from_env, is_main_process
from inverse_audio_synthesis_tpu_torch.train.checkpoint import CheckpointManager
from inverse_audio_synthesis_tpu_torch.train.loop import Trainer
from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask
from inverse_audio_synthesis_tpu_torch.train.runsetup import runsetup
from inverse_audio_synthesis_tpu_torch.utils.config import load_config
from inverse_audio_synthesis_tpu_torch.utils.logging import MetricsLogger
from inverse_audio_synthesis_tpu_torch.utils.profiling import nan_debugging, trace
from inverse_audio_synthesis_tpu_torch.utils.summary import clip_filter_range_stats, summarize_params
from inverse_audio_synthesis_tpu_torch.utils.utils import git_sha


def restore_latest(checkpoint: CheckpointManager, state, what: str):
    """(state, start step): the latest checkpoint restored into ``state``, or the
    state as it was and 0 when there is none or it does not load."""
    start = checkpoint.latest_step()
    if not start:
        return state, 0
    main = is_main_process()
    try:
        state = checkpoint.restore(state)
    except Exception as e:  # e.g. written by another model configuration
        if main:
            print(f"WARNING: could not restore {what} checkpoint step {start} ({e!r}); starting fresh")
        return state, 0
    if main:
        print(f"resuming {what} training from checkpoint step {start}")
    return state, start


def make_logger(cfg, run_dir: Path, prefix: str):
    """The metrics logger on rank 0; None on the other ranks."""
    if not is_main_process():
        return None
    return MetricsLogger(
        run_dir=str(run_dir),
        config={"git_sha": git_sha(), **cfg.to_dict()},
        use_wandb=cfg.get("log") == "wand",
        run_name=f"{prefix}-torch-" + time.strftime("%Y%m%d-%H%M%S"),
    )


def run_cli(app_fn, argv) -> int:
    """Run ``app_fn(cfg)`` in the process group ``torchrun`` describes (none
    without it), leaving the group on the way out."""
    cfg = load_config(overrides=argv)
    init_from_env(cfg)
    try:
        return app_fn(cfg)
    finally:
        finish()


def fit_maybe_traced(cfg, trainer: Trainer, state, start: int, device):
    """``trainer.fit``, inside a profiler trace written to ``profile_dir`` when
    that is set."""
    if not cfg.get("profile_dir"):
        return trainer.fit(state, start_step=start)
    with trace(cfg.profile_dir, cuda=device.type == "cuda"):
        state = trainer.fit(state, start_step=start)
    if is_main_process():
        print(f"profiler trace written to {cfg.profile_dir}")
    return state


def app(cfg) -> int:
    # anomaly mode from before the task is built to the end of the run
    with nan_debugging() if cfg.get("detect_anomaly") else contextlib.nullcontext():
        return _app(cfg)


def _app(cfg) -> int:
    split = runsetup(cfg)
    task = VicregPretrainTask(cfg)
    main = is_main_process()
    state = task.init_state()
    if main:
        name = torch.cuda.get_device_name(task.device) if task.device.type == "cuda" else "cpu"
        print(f"device: {task.device} ({name}); mesh data={task.mesh.data} model={task.mesh.model}; "
              f"render: {'fused' if task.fused_render else 'portable render_voice'}; "
              f"audio tower: {task.audio_tower}; optimizer: {state.optimizer.path}")
        print(summarize_params(state.model, max_depth=2, mesh=task.mesh))

    run_dir = Path(cfg.get("run_dir", "runs"))
    logger = make_logger(cfg, run_dir, "pretrain")
    checkpoint = CheckpointManager(
        directory=str(run_dir / "checkpoints" / "vicreg"),
        every_n_steps=cfg.vicreg.checkpoint_every_nbatches,
        mesh=task.mesh,
    )
    trainer = Trainer(
        task,
        split,
        logger=logger,
        checkpoint=checkpoint,
        limit_train_batches=cfg.vicreg.get("limit_train_batches"),
        limit_val_batches=cfg.vicreg.get("limit_val_batches"),
        val_check_interval=cfg.vicreg.get("val_check_interval"),
        log_every=cfg.get("log_every", 50),
        steps_per_dispatch=cfg.get("steps_per_dispatch", 1),
    )
    if logger is not None:
        logger.log(clip_filter_range_stats())
    state, start = restore_latest(checkpoint, state, "vicreg")
    try:
        fit_maybe_traced(cfg, trainer, state, start, task.device)
    finally:
        if logger is not None:
            logger.finish()
    if main:
        print(f"metrics written to {logger.dir}; checkpoints under {checkpoint.dir}")
    if trainer.interrupted is not None:
        if main:
            print(f"stopped by signal {trainer.interrupted}; checkpoint saved")
        return 75
    return 0


if __name__ == "__main__":
    sys.exit(run_cli(app, sys.argv[1:]))
