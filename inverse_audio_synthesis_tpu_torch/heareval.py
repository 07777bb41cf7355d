"""HEAR embedding-API smoke CLI of the PyTorch port.

    python -m inverse_audio_synthesis_tpu_torch.heareval [vicreg_checkpoint=<dir>] ... [platform=cpu]

Does what the JAX package's root ``heareval.py`` does: loads the VICReg
checkpoint (``vicreg_checkpoint``, default ``<run_dir>/checkpoints/vicreg``),
embeds 4 voices of uniform noise and prints the [4, dim] shape, then prints the
shapes of the scene and 50 ms-hop timestamp embeddings of a 2.5-window clip. The
noise is ``jax.random.uniform``'s, drawn by the port's threefry. Runs on the CUDA
device; ``platform=cpu`` runs on the CPU.
"""

from __future__ import annotations

import sys

from inverse_audio_synthesis_tpu_torch.eval.hear import (
    HearModel,
    get_scene_embeddings,
    get_timestamp_embeddings,
)
from inverse_audio_synthesis_tpu_torch.synth import prng
from inverse_audio_synthesis_tpu_torch.train.pretrain import restore_vicreg
from inverse_audio_synthesis_tpu_torch.utils.config import load_config


def app(cfg) -> int:
    task, state, step = restore_vicreg(cfg)
    if step is not None:
        print(f"loaded vicreg checkpoint step {step}")
    window = task.synth.buffer_size
    audio = prng.uniform(prng.prng_key(0), (4, 1, window), -1.0, 1.0, device=task.device)
    print(tuple(task.embed_audio(state, audio).shape))

    model = HearModel(
        task=task,
        state=state,
        sample_rate=cfg.torchsynth.rate,
        scene_embedding_size=cfg.dim,
        timestamp_embedding_size=cfg.dim,
    )
    clip = prng.uniform(prng.prng_key(1), (2, int(2.5 * window)), -1.0, 1.0, device=task.device)
    scene = get_scene_embeddings(clip, model)
    ts_emb, ts = get_timestamp_embeddings(clip, model)
    print(f"scene {tuple(scene.shape)}; timestamps {tuple(ts_emb.shape)} "
          f"at {float(ts[0, 1] - ts[0, 0]):.1f} ms hop")
    return 0


if __name__ == "__main__":
    sys.exit(app(load_config(overrides=sys.argv[1:])))
