"""Serving export: the inference surfaces as ``torch.export`` programs.

Counterpart of the JAX package's ``serve/export.py``, which writes versioned
StableHLO; here each surface is an ``ExportedProgram`` (ATen graph), saved as a
``.pt2`` archive that ``torch.export.load`` runs without this package's code.

Weights ride as inputs, not as constants: each program takes a dict of tensors
keyed as the module's ``state_dict()`` (what a checkpoint's ``"model"`` entry
holds), and calls the module through ``torch.func.functional_call``, so an
artifact holds the graph alone (kilobytes at the tiny config; baking the full
config's 143 M parameters in would make ~600 MB per artifact). Surfaces:

- ``embed_audio``: (VICReg model weights, audio [B, 1, Ta]) -> [B, dim], the audio
  representation (``audio_repr``, eval mode): the HEAR surface;
- ``predict_params``: (VICReg model weights, head weights, audio [B, 1, Ta]) ->
  params01 [B, nparams], the frozen audio representation through the downstream
  head in eval mode;
- ``render``: (params01 [B, nparams]) -> audio [B, Ta], the portable
  ``render_voice``, with the fixed-seed noise drawn inside the program from the
  config's noise seed (bit-identical to the cached buffer: rows are
  position-keyed). The fused render's CUDA kernel is a ctypes call the exporter
  cannot trace; a server that wants it runs this package live.

Precision: under ``precision: bf16`` the towers' ``torch.autocast(bfloat16)``
region is part of the exported program, as the JAX artifacts carry the model's
compute dtype, so an artifact computes what the live function does. A program
is traced for the device of its example inputs (the task's device) and runs
there; its batch size is fixed, and another one raises.
"""

from __future__ import annotations

import io
import json
from pathlib import Path
from typing import Callable, Dict, Union

import torch
from torch import nn
from torch.export import ExportedProgram

from inverse_audio_synthesis_tpu_torch.synth.config import SynthConfig
from inverse_audio_synthesis_tpu_torch.synth.voice import VOICE_PARAM_SPECS, render_voice

# per-node debug metadata (source stack traces, module paths), which would make
# up most of an artifact; the graph runs without it
_DEBUG_META = ("stack_trace", "nn_module_stack", "source_fn_stack", "from_node", "torch_fn")


class _Surface(nn.Module):
    """Exports ``fn``. The modules ``fn`` calls are not submodules of this one,
    so their tensors are not the program's: they come in as arguments."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn: Callable, args: tuple) -> ExportedProgram:
    ep = torch.export.export(_Surface(fn), args, strict=False)
    ep.example_inputs = None  # the example weights would ride along in the archive
    for gm in ep.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                for key in _DEBUG_META:
                    node.meta.pop(key, None)
    return ep


def model_weights(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The weights an exported surface takes for ``module``: its parameters and
    persistent buffers, keyed as its ``state_dict()``, in a plain dict (the
    programs' input tree is a dict; an OrderedDict is another tree and raises)."""
    return dict(module.state_dict())


def _sub(weights: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)}


def export_embed_audio(task, state, batch: int) -> ExportedProgram:
    """(VICReg model weights, audio [batch, 1, Ta]) -> [batch, dim]."""
    model = state.model.eval()

    def fn(weights, audio):
        with task._autocast():
            return torch.func.functional_call(
                model.backbone_audio, _sub(weights, "backbone_audio."), (audio,)
            )

    audio = torch.zeros((batch, 1, task.synth.buffer_size), device=task.device)
    return _export(fn, (model_weights(model), audio))


def export_predict_params(task, state, batch: int) -> ExportedProgram:
    """(frozen VICReg model weights, head weights, audio [batch, 1, Ta]) ->
    predicted params01 [batch, nparams], for an ``AudioToParamsTask``: its frozen
    audio representation (in the task's ``frozen_bn`` mode) through the head in
    eval mode."""
    frozen, head = task.frozen, state.model.eval()

    def fn(frozen_weights, head_weights, audio):
        with task._autocast():
            audio_repr = torch.func.functional_call(
                frozen.backbone_audio, _sub(frozen_weights, "backbone_audio."), (audio,)
            )
            return torch.func.functional_call(head, head_weights, (audio_repr.float(),))

    audio = torch.zeros((batch, 1, task.synth.buffer_size), device=task.device)
    return _export(fn, (model_weights(frozen), model_weights(head), audio))


def export_render(synth_config: SynthConfig, batch: int, device="cuda") -> ExportedProgram:
    """(params01 [batch, nparams]) -> audio [batch, Ta] through ``render_voice``."""

    def fn(params01):
        return render_voice(params01, synth_config)

    params01 = torch.zeros((batch, len(VOICE_PARAM_SPECS)), device=device)
    return _export(fn, (params01,))


def save_exported(exp: ExportedProgram, path: Union[str, Path, io.BytesIO]) -> None:
    torch.export.save(exp, path)


def load_exported(path: Union[str, Path, io.BytesIO]) -> ExportedProgram:
    """Load an artifact; call it as ``loaded.module()(*args)``."""
    return torch.export.load(path)


def write_manifest(out_dir, cfg, entries: dict) -> None:
    """A small JSON manifest beside the artifacts, so a server can read shapes and
    rates without loading a program (the JAX package's keys)."""
    manifest = {
        "sample_rate": int(cfg.torchsynth.rate),
        "buffer_size_seconds": float(cfg.torchsynth.buffer_size_seconds),
        "dim": int(cfg.dim),
        "nparams": int(cfg.nparams),
        "artifacts": entries,
    }
    (Path(out_dir) / "manifest.json").write_text(json.dumps(manifest, indent=2))
