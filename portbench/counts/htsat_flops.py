"""Model FLOPs of one VICReg training step with the HTS-AT audio tower, from
the reference model's shapes on the meta device (``counts/model_flops.py``'s
counter): the HTS-AT encoder from its image on (the log-mel front end,
``bn0`` and the stretch are not model FLOPs; the patch convolution's input
gradient is, since ``bn0`` trains), the parameter tower, the projector twice,
each layer's backward as ``model_flops`` counts it, the window attention's
backward products, twice its forward (``counts/window_attention.py``), and
the VICReg covariance term in the Gram form the program runs
(``models/vicreg.py:cov_off_diag_sq_sum``): per side one n x n product of
2 n^2 d, and in the backward its two operand gradients of 2 n^2 d each."""

from __future__ import annotations

import json
from functools import lru_cache

import torch

from portbench.counts import window_attention
from portbench.counts.model_flops import _count
from portbench.reference import htsat as H


@lru_cache(maxsize=None)
def _pretrain(key: str) -> float:
    tree = json.loads(key)
    b = int(tree["vicreg"]["batch_size"])
    size = tree["audio_tower"]["htsat"]["spec_size"]
    with torch.device("meta"):
        model = H.VICReg(tree)

    def step():
        image = torch.zeros(b, 1, size, size, device="meta", requires_grad=True)
        x = model.projector(model.backbone_audio.encode(image))
        model.projector(model.backbone_param(torch.zeros(b, tree["nparams"], device="meta")))
        gram = 2.0 * b * b * x.shape[1]
        covariance = 2 * gram + 2 * 2 * gram  # both sides' forward products, then their operand gradients
        return covariance + 2 * window_attention.flops_per_voice(tree, backward=False) * b

    return _count(step, model)


def pretrain_step(tree) -> float:
    """One training step at the tree's ``vicreg.batch_size``."""
    return _pretrain(json.dumps(tree, sort_keys=True))
