"""VICReg pretraining CLI of the PyTorch port.

    python -m inverse_audio_synthesis_tpu_torch.pretrain [vicreg=fast] [dim=64] ... [platform=cpu]

Same config keys and overrides as the JAX package's ``pretrain.py``. Runs on the
CUDA device; ``platform=cpu`` runs on the CPU. Checkpointing is not in the port
yet: the run saves no checkpoint.
"""

from __future__ import annotations

import sys
import time

import torch

from inverse_audio_synthesis_tpu_torch.train.loop import Trainer
from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask
from inverse_audio_synthesis_tpu_torch.train.runsetup import runsetup
from inverse_audio_synthesis_tpu_torch.utils.config import load_config
from inverse_audio_synthesis_tpu_torch.utils.logging import MetricsLogger


def app(cfg) -> int:
    split = runsetup(cfg)
    task = VicregPretrainTask(cfg)
    name = torch.cuda.get_device_name(task.device) if task.device.type == "cuda" else "cpu"
    print(f"device: {task.device} ({name}); render: "
          f"{'fused' if task.fused_render else 'portable render_voice'}")
    print("checkpointing is not in the PyTorch port yet: this run saves no checkpoint")
    state = task.init_state()
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"parameters: {n_params}")

    logger = MetricsLogger(
        run_dir=cfg.get("run_dir", "runs"),
        config=cfg.to_dict(),
        use_wandb=cfg.get("log") == "wand",
        run_name="pretrain-torch-" + time.strftime("%Y%m%d-%H%M%S"),
    )
    trainer = Trainer(
        task,
        split,
        logger=logger,
        limit_train_batches=cfg.vicreg.get("limit_train_batches"),
        limit_val_batches=cfg.vicreg.get("limit_val_batches"),
        val_check_interval=cfg.vicreg.get("val_check_interval"),
        log_every=cfg.get("log_every", 50),
    )
    try:
        trainer.fit(state)
    finally:
        logger.finish()
    print(f"metrics written to {logger.dir}")
    if trainer.interrupted is not None:
        print(f"stopped by signal {trainer.interrupted}")
        return 75
    return 0


if __name__ == "__main__":
    sys.exit(app(load_config(overrides=sys.argv[1:])))
