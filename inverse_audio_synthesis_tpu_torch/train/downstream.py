"""Downstream inverse-synthesis task: frozen VICReg towers -> synth parameter prediction.

Counterpart of the JAX package's ``train/downstream.py``. A trainable head
(``AudioRepresentationToParams``) maps the frozen audio representation to the 78
normalized synth parameters. Training objectives (``audio_to_params.loss``):

- ``embedding``: MSE between the frozen param-tower embeddings of the true and the
  predicted parameters (gradient through the frozen param tower and projector);
- ``param_mse``: MSE against the true parameters;
- ``mel_l1``: mel-L1 between the true audio and the audio rendered from the
  predicted parameters, backpropagated through the synth: the fused render's
  backward kernel (``torchsynth.render_bwd: pallas``) or autograd of the portable
  render (``jnp``). ``mel_rows`` takes the term on the leading rows only;
  ``mel_chunk`` evaluates it exactly in row chunks under
  ``torch.utils.checkpoint``, so the backward holds one chunk's residuals at a time;
- ``combined``: ``sum_i w_i * component_i`` with ``audio_to_params.loss_weights``
  (a zero weight drops its component).

The predicted parameters are cast to float32 before the render, and the render and
the mel term never run under bf16 autocast. The frozen towers are a copy of the
pretrained model that nothing updates: ``frozen_bn: running`` uses them in eval
mode; ``frozen_bn: batch`` normalizes each BatchNorm on the current batch, leaves
the running statistics untouched and turns dropout off.

The test pass resynthesizes from the predicted parameters and reports the fp32
test mel-L1, the multi-resolution STFT loss and the parameter MAE beside their
trivial-baseline floors (constant-0.5 parameters, silence).

Under a distributed mesh (``parallel/mesh.py``) each rank holds its rows of the
global batch (``audio_to_params.batch_size``). Every rank runs the head on the
whole batch's gathered representation and keeps its rows (``_predict``): the
head is small beside the towers, and so its BatchNorm statistics, dropout masks
and GEMM shapes are one process's, and each row's prediction is one process's
bit for bit. (Summed over the data group instead, the statistics and the GEMMs
differ in the last bits, which the grad-through-synth objectives amplify to
O(1) in the gradient, PERF.md.) Every loss and metric is the global batch's: each
rank's partial sum goes through ``global_sum`` (``reduce_from``: identity
backward, since every rank goes on with the same value) and is divided by the
global count. ``mel_rows`` keeps its meaning of the leading rows of the global
batch (a rank takes the overlap of its rows with them, which may be empty), and
``mel_chunk`` counts global rows: a rank evaluates its part of each global chunk
under checkpointing, and the term is the sum of the parts' row-weighted means
over the mel rows, the global mean.

On a CUDA device the train step's synth (the parameter draw, this rank's rows,
the controls and K1 on the task's noise) is one CUDA graph
(``ops/launches.py:CapturedGraph``), captured at the second train step, after
the first ran it eagerly, and replayed at every later train step: about 1,145
eager launches a step become the batch number's ``fill_`` into the graph's 0-dim
int64 input buffer and one ``cudaGraphLaunch``. The synth (``VoiceSource``)
draws no torch RNG and holds no collective, so the graph is valid under a
process group too. Its outputs are the graph's static buffers, handed on without
a copy (the audio is 722 MB at batch 1024): every consumer of one step's synth
is enqueued on the stream before the next replay, and autograd saves neither
(``torch.stack`` copies the true audio for the mel term; ``param_mse`` saves the
difference). On the CPU the synth runs eagerly. ``synthesize`` itself always
runs eagerly and returns fresh tensors, so the test pass, the export and the
audio log, which keep audio across calls, never see the graph's buffers.
``synth_path`` names the path (logged when the task is built) and
``synth_calls`` counts the train step's replays and eager synths;
``ops/render.py:launch_counts`` counts K1's recorded launch at each replay.
"""

from __future__ import annotations

import copy
import logging
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from inverse_audio_synthesis_tpu_torch.models.audio_to_params import AudioRepresentationToParams
from inverse_audio_synthesis_tpu_torch.models.layers import BatchNorm, Dropout
from inverse_audio_synthesis_tpu_torch.ops.launches import CapturedGraph, autocast
from inverse_audio_synthesis_tpu_torch.ops.stft import METHODS as STFT_METHODS
from inverse_audio_synthesis_tpu_torch.ops.stft import MelSpectrogram, mrstft_from_stats, mrstft_stats
from inverse_audio_synthesis_tpu_torch.parallel.collectives import gather_rows, global_sum
from inverse_audio_synthesis_tpu_torch.synth import prng
from inverse_audio_synthesis_tpu_torch.synth.voice import RENDER_BWD, VoiceSource, render_voice_auto
from inverse_audio_synthesis_tpu_torch.train.optim import make_optimizer, reduce_gradients
from inverse_audio_synthesis_tpu_torch.train.pretrain import (
    TrainState,
    VicregPretrainTask,
    steps_in_order,
    synth_config_from_cfg,
)
from inverse_audio_synthesis_tpu_torch.utils.profiling import span

log = logging.getLogger(__name__)

LOSSES = ("embedding", "param_mse", "mel_l1", "combined")
DEFAULT_LOSS_WEIGHTS = {"param_mse": 1.0, "mel_l1": 0.1}


class AudioToParamsTask:
    """Owns the frozen towers, the head's configs, the noise buffer and the
    train/test steps."""

    def __init__(self, cfg, pretrain_task: VicregPretrainTask, pretrain_state: TrainState):
        a2p = cfg.audio_to_params
        self.cfg = cfg
        self.device = pretrain_task.device
        self.mesh = pretrain_task.mesh
        frozen_bn = a2p.get("frozen_bn", "running")
        if frozen_bn not in ("running", "batch"):
            raise ValueError(f"audio_to_params.frozen_bn must be running or batch, got {frozen_bn!r}")
        self.loss_kind = a2p.get("loss", "embedding")
        if self.loss_kind not in LOSSES:
            raise ValueError(f"audio_to_params.loss must be one of {LOSSES}, got {self.loss_kind!r}")
        self.loss_weights = dict(a2p.get("loss_weights") or DEFAULT_LOSS_WEIGHTS)
        self.render_bwd = cfg.torchsynth.get("render_bwd", "pallas")
        if self.render_bwd not in RENDER_BWD:
            raise ValueError(f"torchsynth.render_bwd must be one of {RENDER_BWD}, got {self.render_bwd!r}")

        # the frozen towers: the task's own copy, never updated (the copy draws no
        # dropout masks, so it takes no generator along)
        dropouts = [m for m in pretrain_state.model.modules() if isinstance(m, Dropout)]
        generators = [m.generator for m in dropouts]
        for m in dropouts:
            m.generator = None
        try:
            self.frozen = copy.deepcopy(pretrain_state.model).requires_grad_(False)
        finally:
            for m, gen in zip(dropouts, generators):
                m.generator = gen
        if frozen_bn == "batch":
            for m in self.frozen.modules():
                if isinstance(m, BatchNorm):
                    m.update_stats = False
                if isinstance(m, Dropout):
                    m.rate = 0.0
        self.frozen.train(frozen_bn == "batch")

        self.synth = synth_config_from_cfg(cfg, a2p.batch_size)
        self.rows = self.mesh.local_rows(self.synth.batch_size)
        self._bf16 = cfg.get("precision") == "bf16"
        self._grads_bf16 = self._bf16 and bool(cfg.get("grads_bf16", False))
        # this rank's rows of the noise buffer (at the downstream batch of 1024 a
        # whole buffer is 722 MB)
        self.voices = VoiceSource(self.synth, self.device, self.rows)
        # how train_step runs its synth, fixed here (the module docstring)
        self._graph_synth = self.device.type == "cuda"
        self.synth_path = ("cuda graph: captured after the first eager synth, replayed each train step"
                           if self._graph_synth else "eager: a CPU run")
        self.synth_calls = {"replayed": 0, "eager": 0}
        self._synth_graph: Optional[CapturedGraph] = None
        log.info("train step synth path: %s", self.synth_path)

        # every mel.method is the same float32 transform here (ops/stft.py), so the
        # training and test terms share one; test_method is checked all the same
        m = cfg.mel
        self._test_spectral_method = m.get("test_method", m.get("method", "fft"))
        if self._test_spectral_method not in STFT_METHODS:
            raise ValueError(f"mel.test_method must be one of {STFT_METHODS}, got {self._test_spectral_method!r}")
        self.mel = MelSpectrogram(
            sample_rate=cfg.torchsynth.rate, n_fft=m.n_fft, hop_length=m.hop_length,
            n_mels=m.n_mels, norm=m.norm, mel_scale=m.mel_scale, power=m.power,
            method=m.get("method", "fft"),
        )
        self._warn_if_frozen_embedding_collapsed()

    def _uses_embedding(self) -> bool:
        if self.loss_kind == "combined":
            return bool(self.loss_weights.get("embedding"))
        return self.loss_kind == "embedding"

    def _warn_if_frozen_embedding_collapsed(self) -> None:
        """Warn at init when the frozen projected param embedding barely separates
        different parameter vectors under the BatchNorm mode in use (the eval-mode
        collapse of large-batch pretrains; row-MSE threshold 1e-5): the embedding
        objective then has almost no signal."""
        if not self._uses_embedding():
            return
        probe = prng.uniform(prng.prng_key(0), (8, self.cfg.nparams), device=self.device)
        with torch.no_grad():
            emb = self._embed_params(probe).float()
        row_mse = float(torch.mean((emb[:4] - emb[4:]) ** 2))
        if row_mse < 1e-5:
            log.warning(
                "frozen projected-param-embedding row-MSE is %.3e (<1e-5): the embedding "
                "objective has (almost) no signal under the current BatchNorm mode; set "
                "`audio_to_params.frozen_bn: batch` to normalize the frozen towers on the batch.",
                row_mse,
            )

    # -- state -------------------------------------------------------------------
    def init_state(self) -> TrainState:
        a2p = self.cfg.audio_to_params
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        with torch.device(self.device):
            head = AudioRepresentationToParams(
                nparams=self.cfg.nparams, dim=self.cfg.dim, hidden_norm=a2p.hidden_norm,
                dropout=a2p.dropout, generator=gen,
            )
        dropout_gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed + 2)
        for m in head.modules():
            if isinstance(m, Dropout):
                m.generator = dropout_gen
        optimizer, self.schedule = make_optimizer(
            a2p.optim, a2p.batch_size, list(head.parameters()), a2p.get("scheduler"),
            mesh=self.mesh, grads_bf16=self._grads_bf16,
        )
        return TrainState(0, head, optimizer)

    # -- frozen towers -----------------------------------------------------------
    def _autocast(self):
        return autocast(self.device, self._bf16)

    def _audio_repr(self, audio):
        with self._autocast():
            return self.frozen.audio_repr(audio)

    def _embed_params(self, params01):
        with self._autocast():
            return self.frozen.embed_params(params01)

    def _project_repr(self, repr_):
        with self._autocast():
            return self.frozen.projector(repr_)

    def _render(self, params01: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return render_voice_auto(params01.float(), self.synth, noise, bwd=self.render_bwd)

    def synthesize(self, batch_num) -> Tuple[torch.Tensor, torch.Tensor]:
        """(audio [B, 1, Ta], params01 [B, 78]) of this rank's rows (``VoiceSource``),
        fresh tensors the caller may keep."""
        return self.voices(batch_num)

    def _train_synth(self, batch_num: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The train step's ``synthesize(batch_num)``: eager on the CPU and at the
        first train step, else a replay of its CUDA graph, whose outputs are the
        graph's buffers (the next replay overwrites them)."""
        if not self._graph_synth or not self.synth_calls["eager"]:
            self.synth_calls["eager"] += 1
            return self.synthesize(batch_num)
        if self._synth_graph is None:
            batch_num_buffer = torch.zeros((), dtype=torch.int64, device=self.device)
            self._synth_graph = CapturedGraph(self.synthesize, batch_num_buffer,
                                              "the train step's synth as a CUDA graph")
        self.synth_calls["replayed"] += 1
        return self._synth_graph.replay(batch_num)

    def _shared(self, head, audio, params01, with_pred_emb: bool):
        """(pred_params, repr_loss or None, frozen_loss): the frozen VICReg loss of
        the true pair is a diagnostic; the embedding loss is taken only when asked."""
        with torch.no_grad():
            audio_repr = self._audio_repr(audio)
            true_emb = self._embed_params(params01).float()
            frozen_loss = self._mean((true_emb - self._project_repr(audio_repr).float()) ** 2)
        with self._autocast():
            pred_params = self._predict(head, audio_repr.float())
        repr_loss = None
        if with_pred_emb:
            pred_emb = self._embed_params(pred_params).float()
            repr_loss = self._mean((true_emb - pred_emb) ** 2)
        return pred_params, repr_loss, frozen_loss

    def _predict(self, head, audio_repr: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the head's output on the global batch's
        representation (the head holds no mesh: it sees the whole batch)."""
        if not self.mesh.distributed:
            return head(audio_repr)
        return head(gather_rows(audio_repr, self.mesh))[self.rows]

    def _mean(self, x: torch.Tensor, dim=None) -> torch.Tensor:
        """The mean over the global batch (dim 0 leading) of this rank's rows ``x``:
        all of its elements, or the leading dim only with ``dim=0``."""
        n = (x.numel() if dim is None else x.shape[0]) * self.mesh.data
        return global_sum(torch.sum(x) if dim is None else torch.sum(x, dim), self.mesh) / n

    # -- steps -------------------------------------------------------------------
    def _mel_l1(self, pred_params, true_audio, noise) -> torch.Tensor:
        pred_audio = self._render(pred_params, noise)
        m = self.mel(torch.stack([pred_audio, true_audio]))
        return torch.mean(torch.abs(m[0] - m[1]))

    def _mel_l1_component(self, pred_params, audio) -> torch.Tensor:
        """The grad-through-synth term over the global batch's leading ``mel_rows``
        (all rows if unset), in ``mel_chunk`` row chunks of the global batch under
        activation checkpointing if set. This rank evaluates the rows it holds,
        cut at the chunk boundaries; each part renders with its own
        (position-keyed) noise rows, and the row-weighted sum of the parts' means
        over the mel rows is the unchunked mean."""
        a2p = self.cfg.audio_to_params
        b = self.synth.batch_size
        n_mel = min(a2p.get("mel_rows") or b, b)
        chunk = a2p.get("mel_chunk")
        if chunk and chunk < n_mel and n_mel % chunk:
            raise ValueError(f"mel_chunk={chunk} must divide the mel-term batch {n_mel}")
        lo, hi = self.rows.start, min(self.rows.stop, n_mel)
        cuts = [lo] + [c for c in range(0, n_mel, chunk or n_mel) if lo < c < hi] + [hi]
        total = pred_params.sum() * 0.0  # in the graph when this rank holds no mel rows
        for start, stop in zip(cuts[:-1], cuts[1:]):
            if stop <= start:
                continue
            i, j = start - lo, stop - lo
            args = (pred_params[i:j], audio[i:j, 0, :], self.voices.noise[i:j])
            if chunk and chunk < n_mel:
                value = torch.utils.checkpoint.checkpoint(self._mel_l1, *args, use_reentrant=False)
            else:
                value = self._mel_l1(*args)
            total = total + value * (stop - start)
        return global_sum(total, self.mesh) / n_mel

    def train_step(self, state: TrainState, batch_num: int) -> Tuple[TrainState, Dict[str, Any]]:
        head = state.model
        head.train()
        with span("step/synth"):
            audio, params01 = self._train_synth(batch_num)
        with span("step/forward"):
            pred_params, repr_loss, frozen_loss = self._shared(
                head, audio, params01, with_pred_emb=self._uses_embedding()
            )
            components = {
                "mel_l1": lambda: self._mel_l1_component(pred_params, audio),
                "param_mse": lambda: self._mean((pred_params.float() - params01) ** 2),
                "embedding": lambda: repr_loss,
            }
            aux = {}
            if self.loss_kind == "combined":
                loss = torch.zeros((), device=self.device)
                for name, w in self.loss_weights.items():
                    if not w:
                        continue
                    value = components[name]()
                    aux[name] = value
                    loss = loss + w * value
            else:
                loss = components[self.loss_kind]()
        with span("step/backward"):
            params = state.optimizer.params
            grads = reduce_gradients(torch.autograd.grad(loss, params), self.mesh)
        with span("step/optimizer"):
            state.optimizer.step(list(grads))
        state.step += 1
        metrics = {
            "audio_to_params/train/loss": loss.detach(),
            "audio_to_params/train/frozen_vicreg_loss": frozen_loss,
        }
        for name, value in aux.items():
            metrics[f"audio_to_params/train/{name}"] = value.detach()
        return state, metrics

    def train_step_multi(self, state: TrainState, batch_nums) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """len(batch_nums) train steps in order through ``train_step`` -> (state,
        metrics stacked [k]). Only the synth is a CUDA graph (the module
        docstring). Eager, the batch-1024 step left the card idle 16-35% of a
        traced window (PERF.md): the synth's launches held 97% of that idle with
        the embedding objective, the backward's 48% with ``combined``. A graph of
        the whole step would also take the backward's, but the head's dropout and
        BatchNorm, ``autograd.grad`` through K2, the STFT stack and ``mel_chunk``'s
        recomputation would all have to be made capture-safe first."""
        return steps_in_order(self.train_step, state, batch_nums)

    @torch.no_grad()
    def test_metrics(self, true_audio, params01, pred_params) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Resynthesis from the predicted parameters and the test metrics, each
        beside its trivial-baseline floor. Returns (metrics, pred_audio)."""
        pred_audio = self._render(pred_params, self.voices.noise)
        mels = self.mel(torch.stack([pred_audio, true_audio]))
        # the spectral sums of the global batch
        stats = global_sum(mrstft_stats(pred_audio, true_audio, method=self._test_spectral_method),
                           self.mesh)
        mrstft, mrstft_silence = mrstft_from_stats(stats, self.synth.batch_size, true_audio.shape[-1])
        pred_params = pred_params.float()
        mean = self._mean
        metrics = {
            "audio_to_params/test/mel_l1": mean(torch.abs(mels[0] - mels[1])),
            "audio_to_params/test/mrstft": mrstft,
            "audio_to_params/test/param_mae": mean(torch.abs(pred_params - params01)),
            "audio_to_params/baseline/param_mae_const05": mean(torch.abs(0.5 - params01)),
            "audio_to_params/baseline/mel_l1_silence": mean(torch.abs(mels[1])),
            "audio_to_params/baseline/mrstft_silence": mrstft_silence,
            # [nparams] vectors, written by the CLI as a CSV
            "audio_to_params/test/param_mae_per_param": mean(torch.abs(pred_params - params01), 0),
            "audio_to_params/baseline/param_mae_per_param_const05": mean(
                torch.abs(0.5 - params01), 0
            ),
        }
        return metrics, pred_audio

    @torch.no_grad()
    def test_step(self, state: TrainState, batch_num: int):
        """(metrics, true_audio [B, Ta], pred_audio [B, Ta]) for a test batch: the
        global batch's metrics, this rank's rows of audio."""
        head = state.model
        head.eval()
        audio, params01 = self.synthesize(batch_num)
        pred_params, repr_loss, frozen_loss = self._shared(head, audio, params01, with_pred_emb=True)
        true_audio = audio[:, 0, :]
        metrics, pred_audio = self.test_metrics(true_audio, params01, pred_params)
        metrics = {
            "audio_to_params/test/loss": repr_loss,
            "audio_to_params/test/frozen_vicreg_loss": frozen_loss,
            **metrics,
        }
        return metrics, true_audio, pred_audio

    def log_audio_triplets(self, logger, true_audio, pred_audio, batch_idx, n: int = 16):
        """true | half a second of silence | predicted, for the first ``n`` voices."""
        rate = self.cfg.torchsynth.rate
        silence = np.zeros(rate // 2, dtype=np.float32)
        for i in range(min(n, true_audio.shape[0])):
            clip = np.concatenate([
                true_audio[i].float().cpu().numpy(), silence, pred_audio[i].float().cpu().numpy()
            ])
            logger.log_audio(f"audio-test/{batch_idx}/{i}", clip, rate)
