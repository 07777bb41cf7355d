"""Parameter summaries and the PQMF filter-range diagnostic.

Counterpart of the JAX package's ``utils/summary.py``. The rows are named as in
the JAX parameter tree (``backbone_audio/vision_model``, ``projector/lin0``, ...):
the port's modules carry the JAX submodule names (``models/jax_weights.py``), and
a tensor's leaf is named as JAX names it (``kernel``, ``scale``, ``bias``). Under
tensor parallelism each split tensor counts at its full size, so every rank
prints the summary of the whole model, as JAX does.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from inverse_audio_synthesis_tpu_torch.models.layers import BatchNorm
from inverse_audio_synthesis_tpu_torch.ops.pqmf import PQMF
from inverse_audio_synthesis_tpu_torch.parallel.mesh import split_dim
from inverse_audio_synthesis_tpu_torch.utils.audio_io import read_wav


def _jax_leaf(module: nn.Module, attr: str) -> str:
    if attr == "weight":
        return "scale" if isinstance(module, BatchNorm) else "kernel"
    return attr


def _param_tree(model: nn.Module, mesh=None) -> Dict[str, Any]:
    """{JAX path component: subtree | full element count} of the parameters."""
    tree: Dict[str, Any] = {}
    modules = dict(model.named_modules())
    tp = mesh is not None and mesh.tensor_parallel
    for name, p in model.named_parameters():
        mod_path, _, attr = name.rpartition(".")
        n = p.numel() * (mesh.model if tp and split_dim(name) is not None else 1)
        node = tree
        for part in mod_path.split(".") if mod_path else ():
            node = node.setdefault(part, {})
        node[_jax_leaf(modules[mod_path], attr)] = n
    return tree


def _count(node) -> int:
    return sum(_count(v) for v in node.values()) if isinstance(node, dict) else int(node)


def param_count(model: nn.Module, mesh=None) -> int:
    """Parameters of the whole model (split tensors at their full size)."""
    return _count(_param_tree(model, mesh))


def summarize_params(model: nn.Module, max_depth: int = 2, mesh=None) -> str:
    """Per-module parameter counts up to ``max_depth`` levels of the JAX tree, and
    the total (Lightning's ``ModelSummary(max_depth=2)``)."""
    rows: List[Tuple[str, int]] = []

    def walk(node, path, depth):
        if depth >= max_depth or not isinstance(node, dict):
            rows.append(("/".join(path) or "<root>", _count(node)))
            return
        for k in sorted(node):
            walk(node[k], path + [k], depth + 1)

    tree = _param_tree(model, mesh)
    walk(tree, [], 0)
    width = max((len(r[0]) for r in rows), default=10) + 2
    lines = [f"{'module':<{width}}params"]
    lines += [f"{name:<{width}}{n:,}" for name, n in rows]
    lines.append(f"{'TOTAL':<{width}}{_count(tree):,}")
    return "\n".join(lines)


def filter_range_stats(
    audio: np.ndarray, n_bands: int = 3, sample_rate: int = 44100
) -> Dict[str, float]:
    """Per-band PQMF output range of a clip, on the CPU in float32:
    ``pqmf/band{i}/{min,max,rms}``."""
    x = torch.from_numpy(np.asarray(audio, dtype=np.float32).reshape(1, 1, -1))
    bands = PQMF(n_bands=n_bands).analysis(x)[0].double().numpy()
    stats: Dict[str, float] = {}
    for i, band in enumerate(bands):
        stats[f"pqmf/band{i}/min"] = float(band.min())
        stats[f"pqmf/band{i}/max"] = float(band.max())
        stats[f"pqmf/band{i}/rms"] = float(np.sqrt(np.mean(band**2)))
    return stats


def clip_filter_range_stats(n_samples: Optional[int] = 176400) -> Dict[str, float]:
    """``filter_range_stats`` of the channel mean of the port's vendored clip
    (``assets/test_clip.wav``), cut to ``n_samples``."""
    clip, _ = read_wav(Path(__file__).resolve().parent.parent / "assets" / "test_clip.wav")
    return filter_range_stats(clip.mean(axis=1)[:n_samples])
