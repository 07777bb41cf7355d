"""Import torchvision MobileNetV3-Small weights into the port's vision trunk.

Counterpart of the JAX package's ``models/torch_import.py``. The reference trains
from ImageNet-pretrained torchvision weights (``mobilenet_v3_small(pretrained=...)``);
a torchvision ``features`` state dict file is converted once into the JAX
package's variable layout, the file format both packages read:

    python -m inverse_audio_synthesis_tpu_torch.models.torch_import in.pt out.pkl

Key mapping (torchvision ``features`` naming -> the trunk's):
    features.0.{0,1}                  -> stem.{conv,bn}
    features.{i}.block.{j}.{0,1}      -> bneck_{i-1}.block_{j}.{conv,bn}
    features.{i}.block.{j}.fc{1,2}    -> bneck_{i-1}.block_{j}.fc{1,2}   (squeeze-excite)
    features.12.{0,1}                 -> head.{conv,bn}
Layout of the converted tree: conv kernels HWIO [kH, kW, I/g, O] (torch's OIHW
transposed), BatchNorm weight/bias as ``scale``/``bias`` params, running
mean/var as ``batch_stats``. ``load_into_audio_embedding`` carries the tree into
the port's modules through ``models/jax_weights.py``.
"""

from __future__ import annotations

import pickle
import sys
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from inverse_audio_synthesis_tpu_torch.models.jax_weights import (
    load_jax_variables,
)
from inverse_audio_synthesis_tpu_torch.models.layers import BatchNorm

Converted = Tuple[Dict[str, Any], Dict[str, Any]]


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def convert_mobilenetv3_small_state_dict(state_dict: Dict[str, Any]) -> Converted:
    """torch state dict (tensors or numpy) -> (params, batch_stats) nested dicts in
    the JAX package's MobileNetV3Small layout, values copied as they are."""
    sd = {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v)) for k, v in state_dict.items()}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(tree, path, leaf):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf

    def convert_convbn(src: str, dst: Tuple[str, ...]):
        put(params, dst + ("conv", "kernel"), _conv_kernel(sd[f"{src}.0.weight"]))
        put(params, dst + ("bn", "scale"), sd[f"{src}.1.weight"])
        put(params, dst + ("bn", "bias"), sd[f"{src}.1.bias"])
        put(stats, dst + ("bn", "mean"), sd[f"{src}.1.running_mean"])
        put(stats, dst + ("bn", "var"), sd[f"{src}.1.running_var"])

    convert_convbn("features.0", ("stem",))
    for i in range(1, 12):  # eleven inverted-residual blocks: features.1 ... features.11
        j = 0
        while True:
            src = f"features.{i}.block.{j}"
            base = (f"bneck_{i - 1}", f"block_{j}")
            if f"{src}.0.weight" in sd:  # Conv2dNormActivation
                convert_convbn(src, base)
            elif f"{src}.fc1.weight" in sd:  # SqueezeExcitation
                for fc in ("fc1", "fc2"):
                    put(params, base + (fc, "kernel"), _conv_kernel(sd[f"{src}.{fc}.weight"]))
                    put(params, base + (fc, "bias"), sd[f"{src}.{fc}.bias"])
            else:
                break
            j += 1
    convert_convbn("features.12", ("head",))
    return params, stats


def _trunk_leaves(trunk: nn.Module) -> Iterator[Tuple[str, str, Tuple[int, ...]]]:
    """(collection, JAX path, JAX shape) of every variable of the trunk."""
    for name, mod in trunk.named_modules():
        path = name.replace(".", "/")
        if isinstance(mod, nn.Conv2d):
            o, i, kh, kw = mod.weight.shape
            yield "params", f"{path}/kernel", (kh, kw, i, o)
            if mod.bias is not None:
                yield "params", f"{path}/bias", tuple(mod.bias.shape)
        elif isinstance(mod, BatchNorm):
            n = tuple(mod.weight.shape)
            yield from (("params", f"{path}/scale", n), ("params", f"{path}/bias", n),
                        ("batch_stats", f"{path}/mean", n), ("batch_stats", f"{path}/var", n))


def _flat(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def load_into_audio_embedding(module: nn.Module, converted: Converted,
                              prefix: Tuple[str, ...] = ("backbone_audio", "vision_model")) -> None:
    """Copy converted weights into the trunk at ``prefix`` of ``module`` (a
    VICRegModule by default; ``("vision_model",)`` for an AudioEmbedding), in
    place. Every variable of the trunk must be in the file, and nothing else, at
    its shape; otherwise it raises and loads nothing."""
    params, stats = converted
    trunk = module
    for name in prefix:
        trunk = getattr(trunk, name)
    want = {(c, p): s for c, p, s in _trunk_leaves(trunk)}
    have = {("params", p): np.shape(v) for p, v in _flat(params).items()}
    have.update({("batch_stats", p): np.shape(v) for p, v in _flat(stats).items()})
    if set(want) != set(have):
        missing = sorted("/".join(k) for k in set(want) - set(have))
        extra = sorted("/".join(k) for k in set(have) - set(want))
        raise ValueError(f"vision trunk leaves differ: missing {missing[:5]}, unexpected {extra[:5]} "
                         f"({len(have)} in the file, {len(want)} in the trunk)")
    bad = sorted(f"{'/'.join(k)}: {have[k]} vs {want[k]}" for k in want if tuple(have[k]) != want[k])
    if bad:
        raise ValueError(f"vision trunk shapes differ: {bad[:5]}")

    def nest(tree):
        node: Dict[str, Any] = {}
        leaf = node
        for name in prefix[:-1]:
            leaf = leaf.setdefault(name, {})
        leaf[prefix[-1]] = tree
        return node

    load_jax_variables(module, {"params": nest(params), "batch_stats": nest(stats)})


def load_vision_weights_file(path: str) -> Converted:
    """A vision-weights file -> (params, batch_stats) numpy trees. Takes the
    converted pickle this module's CLI writes (``{"params", "batch_stats"}``) or a
    raw torchvision state dict saved with ``torch.save`` (``features.0.0.weight``
    keys), converted here."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head[:1] == b"\x80":  # a plain pickle (any protocol), or torch.save's legacy format
        try:
            with open(path, "rb") as f:
                blob = pickle.load(f)
            if isinstance(blob, dict) and "params" in blob:
                return blob["params"], blob.get("batch_stats", {})
        except (pickle.UnpicklingError, EOFError):
            pass  # not a converted pickle: read it as a torch file
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return convert_mobilenetv3_small_state_dict(sd)


def main(argv=None) -> int:
    src, dst = (sys.argv[1:] if argv is None else argv)[:2]
    sd = torch.load(src, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    params, stats = convert_mobilenetv3_small_state_dict(sd)
    with open(dst, "wb") as f:
        pickle.dump({"params": params, "batch_stats": stats}, f)
    print(f"wrote {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
