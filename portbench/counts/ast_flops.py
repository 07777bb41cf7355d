"""Model FLOPs of one VICReg training step with the AST audio tower, from the
reference model's shapes on the meta device (``counts/model_flops.py``'s
counter): the AST encoder from the fbank features on (the fbank front end is
not model FLOPs), the parameter tower, the projector twice and the loss's
covariance products, each layer's backward as ``model_flops`` counts it, and
attention's backward products, twice its forward (``counts/attention.py``),
added explicitly: the hooks see only the Linear and Conv layers."""

from __future__ import annotations

import json
from functools import lru_cache

import torch

from portbench.counts import attention
from portbench.counts.model_flops import _count
from portbench.reference import ast as A
from portbench.reference import towers as T


@lru_cache(maxsize=None)
def _pretrain(key: str) -> float:
    tree = json.loads(key)
    b = int(tree["vicreg"]["batch_size"])
    a = tree["audio_tower"]["ast"]
    with torch.device("meta"):
        model = A.VICReg(tree)

    def step():
        features = torch.zeros(b, a["input_tdim"], a["input_fdim"], device="meta")
        x = model.projector(model.backbone_audio.encode(features))
        y = model.projector(model.backbone_param(torch.zeros(b, tree["nparams"], device="meta")))
        T.vicreg_loss(x, y, 1.0, 1.0, 1.0)
        d = x.shape[1]
        covariance = 2 * (2.0 * 2 * d * d * b)  # each covariance product's two operand gradients
        return covariance + 2 * attention.flops_per_voice(tree, backward=False) * b

    return _count(step, model)


def pretrain_step(tree) -> float:
    """One training step at the tree's ``vicreg.batch_size``."""
    return _pretrain(json.dumps(tree, sort_keys=True))
