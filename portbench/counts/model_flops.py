"""Model FLOPs of a unit of work: the matrix products and convolutions of the
reference model at the cell's shapes, counted once from shapes on the meta
device. The forward pass is counted by ``torch.utils.flop_counter.
FlopCounterMode``. The backward is counted layer by layer from the forward's
own products, since FlopCounterMode counts a grouped convolution's backward as
if it were dense (65 times too high for a depthwise 3 x 3 over 64 channels):
each convolution or linear layer adds its forward product once for its weight's
gradient where the weight trains, and once for its input's gradient where the
input needs one; the loss's covariance products add two each. The synth, the
STFT and the elementwise work are not model FLOPs."""

from __future__ import annotations

from functools import lru_cache
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import towers as T


def _count(fn, model=None) -> float:
    """FLOPs of ``fn()``: its forward by FlopCounterMode; where ``fn`` returns a
    number (the backward's FLOPs outside the layers) and not None, the backward
    of the reference layers of ``model`` that the forward reached, and that
    number."""
    layers = []

    def hook(m, inp, out):
        w = m.weight
        per_output = w.shape[1] * (w.shape[2] * w.shape[3] if w.dim() == 4 else 1)
        layers.append((2.0 * out.numel() * per_output, w.requires_grad, inp[0].requires_grad))

    kinds = (T.Conv, T.Linear)
    hooks = [m.register_forward_hook(hook) for m in (model.modules() if model is not None else ())
             if isinstance(m, kinds)]
    try:
        with FlopCounterMode(display=False) as counter:
            backward = fn()
    finally:
        for h in hooks:
            h.remove()
    forward = float(counter.get_total_flops())
    if backward is None:
        return forward
    return forward + sum(f * (w_grad + x_grad) for f, w_grad, x_grad in layers) + backward


def _audio(tree, batch):
    ta = int(round(tree["torchsynth"]["buffer_size_seconds"] * tree["torchsynth"]["rate"]))
    return torch.zeros(batch, 1, ta, device="meta")


@lru_cache(maxsize=None)
def _pretrain(key: str) -> float:
    tree = json.loads(key)
    b = int(tree["vicreg"]["batch_size"])
    with torch.device("meta"):
        model = T.VICReg(tree)

    def step():  # the forward, and the backward's extra FLOPs beyond the layers'
        x, y = model(_audio(tree, b), torch.zeros(b, tree["nparams"], device="meta"))
        T.vicreg_loss(x, y, 1.0, 1.0, 1.0)
        d = x.shape[1]
        return 2 * (2.0 * 2 * d * d * b)  # each covariance product's two operand gradients

    return _count(step, model)


def pretrain_step(tree) -> float:
    """One VICReg training step: both towers, the projector twice, the loss's
    covariance products, and their backward."""
    return _pretrain(json.dumps(tree, sort_keys=True))


@lru_cache(maxsize=None)
def _downstream(key: str, loss: str) -> float:
    tree = json.loads(key)
    a = tree["audio_to_params"]
    b = int(a["batch_size"])
    with torch.device("meta"):
        frozen = T.VICReg(tree).eval().requires_grad_(False)
        head = T.Head(tree["nparams"], tree["dim"], a["dropout"])
    weights = dict(a.get("loss_weights") or {}) if loss == "combined" else {loss: 1.0}

    root = torch.nn.ModuleDict({"frozen": frozen, "head": head})

    def step():
        params = torch.zeros(b, tree["nparams"], device="meta")
        with torch.no_grad():
            r = frozen.backbone_audio(_audio(tree, b))
            frozen.projector(frozen.backbone_param(params))
            frozen.projector(r)  # the frozen VICReg loss of the true pair, a logged diagnostic
        pred = head(r)
        if weights.get("embedding"):
            frozen.projector(frozen.backbone_param(pred))
        return 0.0

    return _count(step, root)


def downstream_step(tree, loss: str) -> float:
    """One downstream step: the frozen towers' forward on the batch and on the
    true parameters, the head's forward and backward, and for the embedding
    objective the frozen parameter tower and projector on the prediction, with
    the gradient through them."""
    return _downstream(json.dumps(tree, sort_keys=True), loss)
