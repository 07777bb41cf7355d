"""The LARS step's least bytes from the configuration tree, and the names of its
kernels.

One LARS step has to read every gradient and weight once and write every
weight once: per parameter the gradient's bytes (2 where ``weights_bf16``
gives a tensor of two dims or more a bf16 gradient, else 4) plus twice the
float32 weight's, 12 bytes for a float32 gradient. The parameters are the
reference model's, counted on the meta device (the AST's where
``audio_tower.name`` is ``ast``). Nothing counted here depends on the batch,
so a traffic's ``overrides`` of it change no count.

LARS needs its norms before its update, so the port's kernels read g and w
twice: 20 bytes a float32 parameter against the 12 counted, a share of its
roofline of 60% at most.

On the card the step is three launches of ``csrc/lars.cu`` (the norm pass, the
fold, the update pass), each named ``lars_...``.
"""

from __future__ import annotations

import json
from functools import lru_cache

import torch

KERNEL_MARK = "lars_"
LAUNCHES_PER_STEP = 3


@lru_cache(maxsize=None)
def _least_bytes(key: str) -> float:
    from portbench.reference import ast as A
    from portbench.reference import towers as T

    tree = json.loads(key)
    ast = (tree.get("audio_tower") or {}).get("name") == "ast"
    with torch.device("meta"):
        model = A.VICReg(tree) if ast else T.VICReg(tree)
    bf16 = bool(tree.get("weights_bf16"))
    return float(sum(p.numel() * ((2 if bf16 and p.dim() >= 2 else 4) + 2 * 4) for p in model.parameters()))


def least_bytes(tree) -> float:
    """Bytes one pretraining step's LARS update has to move."""
    return _least_bytes(json.dumps(tree, sort_keys=True))


def is_lars_kernel(name: str) -> bool:
    return KERNEL_MARK in name
