"""HEAR-style embedding API over the pretrained audio tower.

Counterpart of the JAX package's ``eval/hear.py``: ``load_model`` /
``get_scene_embeddings`` / ``get_timestamp_embeddings``. Scene embeddings tile
the audio into the tower's native window (the synth buffer) and average the
windows' embeddings; timestamp embeddings run the tower over windows centred on
a hop (default 50 ms, HEAR's event-detection granularity). The embedding is
``task.embed_audio``: the audio representation (``audio_repr``), eval mode,
under the task's precision, returned in float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from inverse_audio_synthesis_tpu_torch.train.pretrain import (
    TrainState,
    VicregPretrainTask,
    restore_vicreg,
)


@dataclass
class HearModel:
    task: VicregPretrainTask
    state: TrainState
    sample_rate: int
    scene_embedding_size: int
    timestamp_embedding_size: int

    @property
    def window_samples(self) -> int:
        return self.task.synth.buffer_size

    def embed(self, windows: torch.Tensor) -> torch.Tensor:
        """[N, Ta] windows -> [N, dim] float32 embeddings."""
        return self.task.embed_audio(self.state, windows[:, None, :]).float()


def load_model(cfg, checkpoint_dir: Optional[str] = None) -> HearModel:
    """The audio tower of the config, with the latest VICReg checkpoint under
    ``checkpoint_dir`` loaded when there is one (fresh weights without it)."""
    if checkpoint_dir:
        task, state, _ = restore_vicreg(cfg, checkpoint_dir)
    else:
        task = VicregPretrainTask(cfg)
        state = task.init_state()
    return HearModel(
        task=task,
        state=state,
        sample_rate=cfg.torchsynth.rate,
        scene_embedding_size=cfg.dim,
        timestamp_embedding_size=cfg.dim,
    )


def _window(audio: torch.Tensor, window: int) -> torch.Tensor:
    """[B, T] -> [B, n_win, window] by zero-padded tiling."""
    b, t = audio.shape
    n_win = max(1, -(-t // window))
    return F.pad(audio, (0, n_win * window - t)).reshape(b, n_win, window)


def get_scene_embeddings(audio: torch.Tensor, model: HearModel) -> torch.Tensor:
    """[B, T] float audio in [-1, 1] -> [B, dim] scene embeddings (mean over windows)."""
    audio = torch.as_tensor(audio, dtype=torch.float32, device=model.task.device)
    wins = _window(audio, model.window_samples)
    b, n_win, w = wins.shape
    emb = model.embed(wins.reshape(b * n_win, w))
    return torch.mean(emb.reshape(b, n_win, -1), dim=1)


def get_timestamp_embeddings(
    audio: torch.Tensor, model: HearModel, hop_ms: float = 50.0, chunk: int = 64
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T] -> ([B, n_ts, dim] embeddings, [B, n_ts] centre timestamps in ms).

    Timestamp k's embedding is the tower applied to the native window centred on
    ``k * hop + hop // 2``, zero-padded at the clip's edges. After a left pad of
    ``w // 2`` window k starts at its centre; a right pad of ``w + hop // 2`` keeps
    every window in bounds even when the hop exceeds the window. Windows are
    embedded ``chunk`` timestamps at a time (the last chunk may be shorter: no
    compile-time shape asks for padding), so the [n_ts, w] expansion never exists
    at once."""
    audio = torch.as_tensor(audio, dtype=torch.float32, device=model.task.device)
    b, t = audio.shape
    w = model.window_samples
    hop = max(1, int(round(model.sample_rate * hop_ms / 1000.0)))
    n_ts = max(1, -(-t // hop))
    padded = F.pad(audio, (w // 2, w + hop // 2))
    # window k = padded[:, c_k : c_k + w] with c_k = k * hop + hop // 2
    windows = padded[:, hop // 2 :].unfold(1, w, hop)[:, :n_ts]  # [B, n_ts, w], a view
    embs = []
    for i in range(0, n_ts, chunk):
        part = windows[:, i : i + chunk]
        embs.append(model.embed(part.reshape(-1, w)).reshape(b, part.shape[1], -1))
    emb = torch.cat(embs, dim=1)
    centers = torch.arange(n_ts, dtype=torch.int32, device=audio.device) * hop + hop // 2
    ts = centers.float() * 1000.0 / model.sample_rate
    return emb, ts[None, :].expand(b, n_ts)
