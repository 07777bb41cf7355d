"""VICReg pretraining task: batch number -> synth -> towers -> loss -> LARS step.

Counterpart of the JAX package's ``train/pretrain.py``. One train step:

1. ``sample_voice_params(batch_num)`` -> params01 [B, 78] on the device
   (threefry, bit-identical to the JAX package);
2. ``compute_controls`` and the fused render (the CUDA kernel for a CUDA run,
   its plain version for a CPU run) -> audio [B, Ta], with the noise buffer made
   once per run; geometries the kernel does not take use ``render_voice``;
3. both towers and the shared projector under ``torch.autocast(bfloat16)`` when
   ``precision`` is bf16, the VICReg statistics in float32;
4. backward, then flash LARS with the non-finite guard.

No gradient flows into the synth: params01 are data.

Numerics on CUDA: with ``precision: f32`` matmuls run in full float32 (PyTorch's
default) and convolutions in TF32 (cuDNN's default); with bf16 both run in bf16
under autocast.

Under a process group (``parallel/launch.py``) the task runs on the ``mesh.data
x mesh.model`` mesh of ``parallel/mesh.py``: every rank builds the full model from
the seed, as one rank does, then keeps its shard; it draws the global batch's
parameters and renders its own rows, with the noise rows of their global
positions; the loss and the metrics are those of the global batch, equal on
every rank. ``vicreg.batch_size`` is the global batch.

Config keys honoured: precision, grads_bf16, bn_bf16, mesh.*, param_embed.*,
vicreg.* (batch size, projector spec, loss coefficients, optimizer, scheduler),
image.*, torchsynth.*, seed. Rejected when set away from their defaults (see
ROADMAP.md): weights_bf16, steps_per_dispatch > 1, vicreg.vision_weights_path.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from inverse_audio_synthesis_tpu_torch.models.audioembed import AudioEmbedding
from inverse_audio_synthesis_tpu_torch.models.layers import Dropout
from inverse_audio_synthesis_tpu_torch.models.paramembed import ParamEmbed
from inverse_audio_synthesis_tpu_torch.models.vicreg import (
    VICRegModule,
    parse_projector_spec,
    vicreg_loss,
)
from inverse_audio_synthesis_tpu_torch.parallel.mesh import Mesh, apply_mesh, create_mesh, split_flags
from inverse_audio_synthesis_tpu_torch.synth.config import SynthConfig
from inverse_audio_synthesis_tpu_torch.synth.voice import (
    fused_render_available,
    make_noise,
    render_voice_auto,
    sample_voice_params,
)
from inverse_audio_synthesis_tpu_torch.train.checkpoint import CheckpointManager
from inverse_audio_synthesis_tpu_torch.train.optim import (
    make_optimizer,
    reduce_gradients,
    schedule_value,
)

log = logging.getLogger(__name__)


def resolve_device(cfg) -> torch.device:
    """The CUDA device, or the CPU when the config asks for it with platform=cpu.
    Raises when there is no CUDA device and the CPU was not asked for."""
    platform = cfg.get("platform")
    if platform == "cpu":
        return torch.device("cpu")
    if platform is not None:
        raise ValueError(f"platform={platform!r}: the port runs on CUDA (null) or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass platform=cpu to run the port on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def check_supported(cfg) -> None:
    """Reject the config keys the port does not implement yet, instead of ignoring them."""
    if cfg.get("weights_bf16", False):
        raise NotImplementedError("weights_bf16=true is not supported by the port yet")
    if int(cfg.get("steps_per_dispatch", 1) or 1) > 1:
        raise NotImplementedError("steps_per_dispatch>1 is not supported by the port yet")
    if cfg.vicreg.get("vision_weights_path"):
        raise NotImplementedError("vicreg.vision_weights_path is not supported by the port yet")


def mesh_from_cfg(cfg) -> Mesh:
    """The config's ``mesh.data`` x ``mesh.model`` mesh over the process group;
    raises ValueError when its size is not the group's."""
    mesh = cfg.get("mesh") or {}
    return create_mesh(int(mesh.get("data", -1)), int(mesh.get("model", 1)))


def synth_config_from_cfg(cfg, batch_size: int) -> SynthConfig:
    scfg = SynthConfig(
        batch_size=batch_size,
        reproducible=cfg.torchsynth.reproducible,
        sample_rate=cfg.torchsynth.rate,
        buffer_size_seconds=cfg.torchsynth.buffer_size_seconds,
        control_rate=cfg.torchsynth.get("control_rate", 441),
        seed=cfg.seed,
    )
    expected = 3 * cfg.image.height * cfg.image.width
    if scfg.buffer_size != expected:
        raise ValueError(
            f"torchsynth buffer ({scfg.buffer_size} samples) must tile the PQMF "
            f"pseudo-image: 3x{cfg.image.height}x{cfg.image.width} = {expected}"
        )
    return scfg


def build_vicreg_model(cfg, generator: Optional[torch.Generator] = None) -> VICRegModule:
    bf16 = cfg.get("precision") == "bf16"
    # bn_bf16: BatchNorm's normalized output in bf16; its statistics stay float32
    bn_dtype = torch.bfloat16 if bf16 and cfg.get("bn_bf16", False) else torch.float32
    return VICRegModule(
        backbone_audio=AudioEmbedding(
            dim=cfg.dim,
            image_size=(cfg.image.height, cfg.image.width),
            bn_dtype=bn_dtype,
            generator=generator,
        ),
        backbone_param=ParamEmbed(
            nparams=cfg.nparams,
            dim=cfg.dim,
            hidden_norm=cfg.param_embed.hidden_norm,
            dropout=cfg.param_embed.dropout,
            generator=generator,
        ),
        projector_dims=parse_projector_spec(cfg.vicreg.mlp, cfg.dim, cfg.embeddim),
        bn_dtype=bn_dtype,
        generator=generator,
    )


@dataclass
class TrainState:
    """Step count, model (parameters and BatchNorm statistics) and optimizer
    (schedule count and non-finite counter); train_step updates it in place."""

    step: int
    model: VICRegModule
    optimizer: Any


class VicregPretrainTask:
    """Owns the configs, the device, the noise buffer and the train/val steps."""

    def __init__(self, cfg):
        check_supported(cfg)
        self.cfg = cfg
        self.mesh = mesh_from_cfg(cfg)
        self.device = resolve_device(cfg)
        self.synth = synth_config_from_cfg(cfg, cfg.vicreg.batch_size)
        self.rows = self.mesh.local_rows(self.synth.batch_size)
        self._bf16 = cfg.get("precision") == "bf16"
        self._grads_bf16 = self._bf16 and bool(cfg.get("grads_bf16", False))
        # the fixed-seed noise buffer of this rank's rows, made once per run (rows
        # are position-keyed)
        self._noise = make_noise(
            self.synth, self.device, self.rows.stop - self.rows.start, self.rows.start
        )
        self.fused_render = fused_render_available(self.synth)
        log.info(
            "render path: %s",
            ("CUDA kernel" if self.device.type == "cuda" else "kernel's plain version")
            if self.fused_render
            else "plain render_voice (geometry not taken by the kernel)",
        )

    # -- state -----------------------------------------------------------------
    def init_state(self) -> TrainState:
        seed = self.cfg.seed
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.device(self.device):
            model = build_vicreg_model(self.cfg, generator=gen)
        apply_mesh(model, self.mesh)  # the full model from the seed, then this rank's shard
        dropout_gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.generator = dropout_gen
        optimizer, self.schedule = make_optimizer(
            self.cfg.vicreg.optim,
            self.cfg.vicreg.batch_size,
            list(model.parameters()),
            self.cfg.vicreg.get("scheduler"),
            mesh=self.mesh,
            split=split_flags(model, self.mesh),
        )
        return TrainState(0, model, optimizer)

    # -- steps -------------------------------------------------------------------
    def _autocast(self):
        return torch.autocast(
            device_type=self.device.type, dtype=torch.bfloat16, enabled=self._bf16
        )

    def synthesize(self, batch_num: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(audio [B, 1, Ta], params01 [B, 78]) of this rank's rows for a batch
        number: the global batch's parameters are drawn, its rows rendered."""
        params01 = sample_voice_params(batch_num, self.synth, self.device)[self.rows]
        audio = render_voice_auto(params01, self.synth, noise=self._noise)
        return audio[:, None, :], params01

    def _losses(self, x: torch.Tensor, y: torch.Tensor):
        return vicreg_loss(
            x, y,
            sim_coeff=self.cfg.vicreg.sim_coeff,
            std_coeff=self.cfg.vicreg.std_coeff,
            cov_coeff=self.cfg.vicreg.cov_coeff,
            cov_operand_dtype=torch.bfloat16 if self._bf16 else None,
            mesh=self.mesh if self.mesh.distributed else None,
        )

    def train_step(self, state: TrainState, batch_num: int) -> Tuple[TrainState, Dict[str, Any]]:
        model = state.model
        model.train()
        audio, params01 = self.synthesize(batch_num)
        with self._autocast():
            x, y = model(audio, params01)
        loss, repr_l, std_l, cov_l = self._losses(x, y)
        params = state.optimizer.params
        grads = reduce_gradients(torch.autograd.grad(loss, params), self.mesh)
        if self._grads_bf16:
            grads = [g.to(torch.bfloat16) if g.dim() >= 2 else g for g in grads]
        lr = schedule_value(self.schedule, state.step)  # lr of the update being applied
        state.optimizer.step(list(grads))
        state.step += 1
        metrics = {
            "vicreg/train/loss": loss.detach(),
            "vicreg/train/repr_loss": repr_l.detach(),
            "vicreg/train/std_loss": std_l.detach(),
            "vicreg/train/cov_loss": cov_l.detach(),
            "lr": lr,
        }
        return state, metrics

    @torch.no_grad()
    def val_step(self, state: TrainState, batch_num: int) -> Dict[str, torch.Tensor]:
        model = state.model
        model.eval()
        audio, params01 = self.synthesize(batch_num)
        with self._autocast():
            x, y = model(audio, params01)
        loss, repr_l, std_l, cov_l = self._losses(x, y)
        return {
            "vicreg/validation/loss": loss,
            "vicreg/validation/repr_loss": repr_l,
            "vicreg/validation/std_loss": std_l,
            "vicreg/validation/cov_loss": cov_l,
        }

    @torch.no_grad()
    def embed_audio(self, state: TrainState, audio: torch.Tensor) -> torch.Tensor:
        """[B, 1, Ta] audio -> [B, dim] representation (eval-mode towers)."""
        model: nn.Module = state.model
        model.eval()
        with self._autocast():
            return model.audio_repr(audio.to(self.device))

    @torch.no_grad()
    def project_audio(self, state: TrainState, audio: torch.Tensor) -> torch.Tensor:
        """[B, 1, Ta] audio -> [B, embeddim]: the projector's output
        (``model.embed_audio``, eval-mode towers), the retrieval eval's embedding."""
        model: nn.Module = state.model
        model.eval()
        with self._autocast():
            return model.embed_audio(audio.to(self.device))


def restore_vicreg(
    cfg, checkpoint_dir: Optional[str] = None
) -> Tuple[VicregPretrainTask, TrainState, Optional[int]]:
    """(task, state, step): a fresh task and state with the latest VICReg
    checkpoint under ``checkpoint_dir`` (default: ``vicreg_checkpoint``, else
    ``<run_dir>/checkpoints/vicreg``) loaded into the state; step is None, and the
    state fresh, when there is none. A checkpoint that does not load raises."""
    task = VicregPretrainTask(cfg)
    state = task.init_state()
    run_dir = Path(cfg.get("run_dir", "runs"))
    directory = checkpoint_dir or cfg.get("vicreg_checkpoint") or str(run_dir / "checkpoints" / "vicreg")
    checkpoint = CheckpointManager(directory, mesh=task.mesh)
    step = checkpoint.latest_step()
    if step is not None:
        state = checkpoint.restore(state)
    return task, state, step
