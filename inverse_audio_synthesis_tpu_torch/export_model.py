"""Export the inference surfaces of the PyTorch port as ``torch.export`` programs.

    python -m inverse_audio_synthesis_tpu_torch.export_model +export_dir=runs/export \
        +export_batch=128 [vicreg_checkpoint=<dir>] [downstream_checkpoint=<dir>] ... [platform=cpu]

Does what the JAX package's ``tools/export_model.py`` does: loads the VICReg
checkpoint (``vicreg_checkpoint``, default ``<run_dir>/checkpoints/vicreg``; random
weights with a warning when there is none), writes ``embed_audio.pt2`` and
``render.pt2``, and ``predict_params.pt2`` when a downstream head checkpoint exists
(``downstream_checkpoint``, default ``<run_dir>/checkpoints/audio_to_params``),
then ``manifest.json``, all under ``export_dir``. Weights are not in the programs:
a server passes the checkpoint's tensors as arguments (``serve/export.py``).
``export_platforms`` is accepted for the JAX config's sake and must name only the
port's device (``cuda``, or ``cpu`` with ``platform=cpu``): a program runs on the
device it was traced for. Runs on the CUDA device; ``platform=cpu`` runs on the CPU.
"""

from __future__ import annotations

import sys
from pathlib import Path

from inverse_audio_synthesis_tpu_torch.serve import (
    export_embed_audio,
    export_predict_params,
    export_render,
    save_exported,
    write_manifest,
)
from inverse_audio_synthesis_tpu_torch.train.checkpoint import CheckpointManager
from inverse_audio_synthesis_tpu_torch.train.downstream import AudioToParamsTask
from inverse_audio_synthesis_tpu_torch.train.pretrain import resolve_device, restore_vicreg
from inverse_audio_synthesis_tpu_torch.utils.config import load_config


def check_platforms(platforms, device_type: str) -> None:
    """Refuse an ``export_platforms`` naming any device but the port's."""
    if isinstance(platforms, str):
        platforms = [p for p in platforms.split(",") if p]
    others = sorted(set(platforms or ()) - {device_type})
    if others:
        raise ValueError(
            f"export_platforms names {others}: the port exports for its own device "
            f"({device_type}) only"
        )


def app(cfg) -> int:
    out_dir = Path(cfg.get("export_dir", "runs/export"))
    batch = int(cfg.get("export_batch", 128))
    platform = resolve_device(cfg).type
    check_platforms(cfg.get("export_platforms"), platform)
    task, state, step = restore_vicreg(cfg)
    out_dir.mkdir(parents=True, exist_ok=True)
    if step is not None:
        print(f"loaded vicreg checkpoint step {step}")
    else:
        print("WARNING: no vicreg checkpoint found; exporting random init")
    t = task.synth.buffer_size
    entries = {}

    save_exported(export_embed_audio(task, state, batch), out_dir / "embed_audio.pt2")
    entries["embed_audio"] = {
        "in": f"(vicreg model weights, audio[{batch},1,{t}] f32)",
        "out": f"[{batch},{cfg.dim}] f32",
        "platforms": [platform],
    }
    print(f"exported embed_audio for platforms ['{platform}']")

    save_exported(export_render(task.synth, batch, task.device), out_dir / "render.pt2")
    entries["render"] = {
        "in": f"(params01[{batch},{cfg.nparams}] f32)",
        "out": f"[{batch},{t}] f32",
        "platforms": [platform],
    }
    print(f"exported render for platforms ['{platform}']")

    run_dir = Path(cfg.get("run_dir", "runs"))
    head_dir = cfg.get("downstream_checkpoint") or str(run_dir / "checkpoints" / "audio_to_params")
    head_ckpt = CheckpointManager(head_dir)
    head_step = head_ckpt.latest_step()
    if head_step is not None:
        ds_task = AudioToParamsTask(cfg, task, state)
        head_state = head_ckpt.restore(ds_task.init_state())
        print(f"loaded downstream checkpoint step {head_step}")
        save_exported(export_predict_params(ds_task, head_state, batch), out_dir / "predict_params.pt2")
        entries["predict_params"] = {
            "in": f"(vicreg model weights, head weights, audio[{batch},1,{t}] f32)",
            "out": f"[{batch},{cfg.nparams}] f32",
            "platforms": [platform],
        }
        print(f"exported predict_params for platforms ['{platform}']")
    else:
        print(f"no downstream checkpoint under {head_dir}; skipping predict_params")

    write_manifest(out_dir, cfg, entries)
    print(f"wrote {out_dir}/manifest.json")
    return 0


if __name__ == "__main__":
    sys.exit(app(load_config(overrides=sys.argv[1:])))
