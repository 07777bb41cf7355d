"""VICReg pretraining task: batch number -> synth -> towers -> loss -> LARS step.

Counterpart of the JAX package's ``train/pretrain.py``. One train step:

1. ``sample_voice_params(batch_num)`` -> params01 [B, 78] on the device
   (threefry, bit-identical to the JAX package);
2. ``compute_controls`` and the fused render (the CUDA kernel for a CUDA run,
   its plain version for a CPU run) -> audio [B, Ta], with the noise buffer made
   once per run (``synth/voice.py:VoiceSource``); geometries the kernel does not
   take use ``render_voice``;
3. both towers and the shared projector under ``torch.autocast(bfloat16)`` when
   ``precision`` is bf16, the VICReg statistics in float32;
4. backward, then flash LARS with the non-finite guard (on a CUDA device three
   launches of ``csrc/lars.cu``, ``train/optim.py:FusedLars``; under
   ``grads_bf16`` the optimizer rounds the gradients of >= 2 dims to bf16).

Under a profiler the four are the spans ``step/synth``, ``step/forward``,
``step/backward`` and ``step/optimizer`` (``utils/profiling.py:span``; the
downstream step has the same four); a graph's replay is ``step/graph_replay``
and its capture ``step/graph_capture``.

No gradient flows into the synth: params01 are data.

Numerics on CUDA: with ``precision: f32`` matmuls run in full float32 (PyTorch's
default) and convolutions in TF32 (cuDNN's default); with bf16 both run in bf16
under autocast.

``weights_bf16``: the >=2-D parameters are stored in bf16 (1-D ones stay float32)
and the optimizer keeps float32 masters (``train/optim.py:Fp32Master``), whatever
the precision, as in JAX; the layers compute in the precision's dtype
(``models/layers.py``). ``vicreg.vision_weights_path`` loads a torchvision
MobileNetV3-Small trunk (``models/torch_import.py``) into the audio tower at
``init_state``, before the mesh keeps this rank's shard.

``train_step_multi`` runs k steps for one dispatch of the loop
(``steps_per_dispatch``). On a CUDA run with no process group and anomaly mode
off the k steps are one CUDA graph (``ops/launches.py:CapturedGraph``, which
says what a graph needs), captured once per dispatch length after the loop's
first dispatch, always a single eager step, and replayed. It reads the k batch
and step numbers from its [2, k] int64 input buffer and draws dropout from the
registered generator; the parameters, BatchNorm statistics, the optimizer's
count, counter and masters and the noise are all updated in place. A capture or
replay that fails raises: there is no fallback. On the CPU, under a process
group (gloo cannot be captured) or in anomaly mode the k steps run in order
through ``train_step``. The path is chosen when the task is built and logged at
the first dispatch.

Under a process group (``parallel/launch.py``) the task runs on the ``mesh.data
x mesh.model`` mesh of ``parallel/mesh.py``: every rank builds the full model from
the seed, as one rank does, then keeps its shard; it draws the global batch's
parameters and renders its own rows, with the noise rows of their global
positions; the loss and the metrics are those of the global batch, equal on
every rank. ``vicreg.batch_size`` is the global batch.

Config keys honoured: precision, grads_bf16, bn_bf16, weights_bf16,
detect_anomaly (the graph path's choice; the CLI turns anomaly mode on),
mesh.*, param_embed.*, vicreg.* (batch size, projector spec, loss coefficients,
optimizer, scheduler, vision_weights_path, pretrained_vision_model), image.*,
audio_tower.* (``build_audio_tower``; a tree without it builds MobileNetV3-Small),
torchsynth.*, seed. ``steps_per_dispatch`` is the loop's (``train/loop.py``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from inverse_audio_synthesis_tpu_torch.models.ast import AST
from inverse_audio_synthesis_tpu_torch.models.audioembed import AudioEmbedding
from inverse_audio_synthesis_tpu_torch.models.torch_import import (
    load_into_audio_embedding,
    load_vision_weights_file,
)
from inverse_audio_synthesis_tpu_torch.models.layers import Dropout
from inverse_audio_synthesis_tpu_torch.models.paramembed import ParamEmbed
from inverse_audio_synthesis_tpu_torch.models.vicreg import (
    VICRegModule,
    parse_projector_spec,
    vicreg_loss,
)
from inverse_audio_synthesis_tpu_torch.parallel.mesh import Mesh, apply_mesh, create_mesh, split_flags
from inverse_audio_synthesis_tpu_torch.ops.launches import CapturedGraph, autocast
from inverse_audio_synthesis_tpu_torch.synth.config import SynthConfig
from inverse_audio_synthesis_tpu_torch.synth.voice import VoiceSource
from inverse_audio_synthesis_tpu_torch.train.checkpoint import CheckpointManager
from inverse_audio_synthesis_tpu_torch.train.optim import (
    Fp32Master,
    make_optimizer,
    reduce_gradients,
    schedule_value,
)
from inverse_audio_synthesis_tpu_torch.utils.profiling import span

log = logging.getLogger(__name__)
_WARNED_RANDOM_INIT = False  # the random-init trunk warning, once per process


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


def audio_tower_name(cfg) -> str:
    """``audio_tower.name``; a tree without the key builds the MobileNetV3-Small tower."""
    return (cfg.get("audio_tower") or {}).get("name", "mobilenetv3_small")


def build_audio_tower(cfg, bn_dtype=torch.float32, generator: Optional[torch.Generator] = None) -> nn.Module:
    """The audio tower ``audio_tower.name`` selects: ``mobilenetv3_small`` (the PQMF
    pseudo-image through MobileNetV3-Small, ``models/audioembed.py``) or ``ast``
    (the Kaldi fbank through the Audio Spectrogram Transformer of
    ``audio_tower.ast``, ``models/ast.py``)."""
    name = audio_tower_name(cfg)
    if name == "mobilenetv3_small":
        return AudioEmbedding(dim=cfg.dim, image_size=(cfg.image.height, cfg.image.width),
                              bn_dtype=bn_dtype, generator=generator)
    if name == "ast":
        return AST(dim=cfg.dim, sample_rate=cfg.torchsynth.rate, generator=generator,
                   **dict(cfg.audio_tower.get("ast") or {}))
    raise ValueError(f"audio_tower.name={name!r}: the port builds mobilenetv3_small or ast")


def describe_audio_tower(tower: nn.Module) -> str:
    """The audio tower's name and counters, for the log."""
    if isinstance(tower, AST):
        backends = ", ".join(b.name for b in tower.sdpa_backends)
        return f"ast ({tower.tokens_per_voice} tokens a voice; SDPA backends {backends})"
    return "mobilenetv3_small"


def build_vicreg_model(cfg, generator: Optional[torch.Generator] = None) -> VICRegModule:
    bf16 = cfg.get("precision") == "bf16"
    # bn_bf16: BatchNorm's normalized output in bf16; its statistics stay float32
    bn_dtype = torch.bfloat16 if bf16 and cfg.get("bn_bf16", False) else torch.float32
    return VICRegModule(
        backbone_audio=build_audio_tower(cfg, bn_dtype, generator),
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


def steps_in_order(train_step: Callable, state: TrainState,
                   batch_nums: Sequence) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """``train_step`` on each batch number in order -> (state, metrics stacked [k])."""
    rows = []
    for n in batch_nums:
        state, m = train_step(state, n)
        rows.append(m)
    return state, {k: torch.stack([m[k] for m in rows]) for k in rows[0]}


class VicregPretrainTask:
    """Owns the configs, the device, the noise buffer and the train/val steps."""

    METRICS = ("vicreg/train/loss", "vicreg/train/repr_loss", "vicreg/train/std_loss",
               "vicreg/train/cov_loss", "lr")

    def __init__(self, cfg):
        self.cfg = cfg
        self.mesh = mesh_from_cfg(cfg)
        self.device = resolve_device(cfg)
        self.synth = synth_config_from_cfg(cfg, cfg.vicreg.batch_size)
        self.rows = self.mesh.local_rows(self.synth.batch_size)
        self._bf16 = cfg.get("precision") == "bf16"
        self._grads_bf16 = self._bf16 and bool(cfg.get("grads_bf16", False))
        self._weights_bf16 = bool(cfg.get("weights_bf16", False))
        self.voices = VoiceSource(self.synth, self.device, self.rows)
        log.info(
            "render path: %s",
            ("CUDA kernel" if self.device.type == "cuda" else "kernel's plain version")
            if self.voices.fused_render
            else "plain render_voice (geometry not taken by the kernel)",
        )
        # how train_step_multi runs k steps, fixed here
        anomaly = bool(cfg.get("detect_anomaly", False)) or torch.is_anomaly_enabled()
        eager = ("a CPU run" if self.device.type != "cuda" else
                 "a process group is not captured" if self.mesh.distributed else
                 "anomaly mode" if anomaly else None)
        self.dispatch_path = ("cuda graph: one graph per dispatch length, replayed" if eager is None
                              else f"eager: in order through train_step ({eager})")
        self.audio_tower = audio_tower_name(cfg)  # with its counters once init_state builds it
        # dispatch length -> its graph; None on the eager path
        self._graphs: Optional[Dict[int, CapturedGraph]] = {} if eager is None else None
        self._eager_steps = 0
        self._dispatch_logged = False

    # -- state -----------------------------------------------------------------
    def init_state(self) -> TrainState:
        seed = self.cfg.seed
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.device(self.device):
            model = build_vicreg_model(self.cfg, generator=gen)
        self._maybe_load_vision_weights(model)
        self.audio_tower = describe_audio_tower(model.backbone_audio)
        if self._weights_bf16:
            # bf16 storage of the >=2-D weights; 1-D ones (biases, BatchNorm) stay
            # float32, as the JAX package keeps them
            for p in model.parameters():
                if p.dim() >= 2:
                    p.data = p.data.to(torch.bfloat16)
        apply_mesh(model, self.mesh)  # the full model from the seed, then this rank's shard
        self._dropout_gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.generator = self._dropout_gen
        named = list(model.named_parameters())
        names = [n for n, _ in named]

        def make(params):
            optimizer, self.schedule = make_optimizer(
                self.cfg.vicreg.optim,
                self.cfg.vicreg.batch_size,
                params,
                self.cfg.vicreg.get("scheduler"),
                mesh=self.mesh,
                split=split_flags(model, self.mesh),
                names=names,
                grads_bf16=self._grads_bf16,
            )
            return optimizer

        params = [p for _, p in named]
        optimizer = Fp32Master(params, make, names) if self._weights_bf16 else make(params)
        return TrainState(0, model, optimizer)

    def _maybe_load_vision_weights(self, model: VICRegModule) -> None:
        """Load a torchvision trunk into the audio tower when
        ``vicreg.vision_weights_path`` is set (the reference trains from ImageNet
        weights); warn once per process when ``pretrained_vision_model`` asks for
        them and no path is set. Another audio tower refuses a path (the file is a
        MobileNetV3-Small trunk) and warns of nothing."""
        global _WARNED_RANDOM_INIT
        path = self.cfg.vicreg.get("vision_weights_path")
        if audio_tower_name(self.cfg) != "mobilenetv3_small":
            if path:
                raise ValueError(f"vicreg.vision_weights_path={path!r} is a MobileNetV3-Small trunk; the "
                                 f"{audio_tower_name(self.cfg)} audio tower cannot load it")
            return
        if path:
            load_into_audio_embedding(model, load_vision_weights_file(path))
            log.info("loaded pretrained vision trunk from %s", path)
        elif self.cfg.vicreg.get("pretrained_vision_model") and not _WARNED_RANDOM_INIT:
            _WARNED_RANDOM_INIT = True
            log.warning(
                "pretrained_vision_model=true but vicreg.vision_weights_path is unset: the "
                "vision trunk is random-init. Convert torchvision weights with `python -m "
                "inverse_audio_synthesis_tpu_torch.models.torch_import` and set the path."
            )

    # -- steps -------------------------------------------------------------------
    def _autocast(self):
        return autocast(self.device, self._bf16)

    def synthesize(self, batch_num) -> Tuple[torch.Tensor, torch.Tensor]:
        """(audio [B, 1, Ta], params01 [B, 78]) of this rank's rows (``VoiceSource``)."""
        return self.voices(batch_num)

    def _losses(self, x: torch.Tensor, y: torch.Tensor):
        return vicreg_loss(
            x, y,
            sim_coeff=self.cfg.vicreg.sim_coeff,
            std_coeff=self.cfg.vicreg.std_coeff,
            cov_coeff=self.cfg.vicreg.cov_coeff,
            cov_operand_dtype=torch.bfloat16 if self._bf16 else None,
            mesh=self.mesh if self.mesh.distributed else None,
        )

    def _step(self, state: TrainState, batch_num, step) -> Dict[str, torch.Tensor]:
        """One update of ``state`` in place (not its step count); ``batch_num`` and
        ``step`` are ints or int64 tensors on the device. Returns the metrics."""
        model = state.model
        model.train()
        with span("step/synth"):
            audio, params01 = self.synthesize(batch_num)
        with span("step/forward"):
            with self._autocast():
                x, y = model(audio, params01)
            loss, repr_l, std_l, cov_l = self._losses(x, y)
        with span("step/backward"):
            params = state.optimizer.params
            grads = reduce_gradients(torch.autograd.grad(loss, params), self.mesh)
        with span("step/optimizer"):
            lr = schedule_value(self.schedule, step)  # lr of the update being applied
            state.optimizer.step(list(grads))
        return dict(zip(self.METRICS, (loss.detach(), repr_l.detach(), std_l.detach(),
                                       cov_l.detach(), lr)))

    def train_step(self, state: TrainState, batch_num: int) -> Tuple[TrainState, Dict[str, Any]]:
        metrics = self._step(state, batch_num, state.step)
        state.step += 1
        self._eager_steps += 1
        return state, metrics

    def train_step_multi(self, state: TrainState, batch_nums) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """len(batch_nums) train steps -> (state, metrics stacked [k]), the same
        steps as that many ``train_step`` calls, by ``dispatch_path``. On the graph
        path a task's first dispatch runs eagerly when no eager step has run yet:
        every lazy set-up (the render library, cuBLAS and cuDNN handles, cached
        filters) happens outside a capture."""
        if not self._dispatch_logged:
            self._dispatch_logged = True
            log.info("steps_per_dispatch path: %s; optimizer: %s; audio tower: %s", self.dispatch_path,
                     state.optimizer.path, self.audio_tower)
        if self._graphs is None or not self._eager_steps:
            return steps_in_order(self.train_step, state, batch_nums)
        k = len(batch_nums)
        if k not in self._graphs:
            # the k steps on a [2, k] int64 buffer of batch and step numbers -> the
            # metrics [n metrics, k]; the steps' phase spans are recorded here, at
            # capture, and not at replay
            def steps(inputs):
                return torch.stack([
                    torch.stack([v.float() for v in self._step(state, inputs[0, j], inputs[1, j]).values()])
                    for j in range(k)
                ], dim=1)

            self._graphs[k] = CapturedGraph(steps, torch.zeros((2, k), dtype=torch.int64, device=self.device),
                                            f"a CUDA graph of {k} train steps", (self._dropout_gen,))
        with span("step/graph_replay"):
            host = torch.tensor([list(batch_nums), list(range(state.step, state.step + k))],
                                dtype=torch.int64, pin_memory=True)
            out = self._graphs[k].replay(host).clone()
        state.step += k
        return state, dict(zip(self.METRICS, out.unbind(0)))

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
