"""The frozen counts against hand counts at small shapes."""

import json

import pytest
import torch

from conftest import HERE


def test_render_counts_by_hand():
    from portbench.counts import render

    b, ta, tc = 2, 400, 4  # ratio 100, one tile of 32 segments
    assert render.k1(b, ta, tc) == (182 * 800, 4 * (800 + 40 + 32 + 800))
    assert render.k2(b, ta, tc) == (274 * 800, 4 * (1600 + 80 + 64 + 2 * 2 * 2 * 32))
    t = render.least_seconds("render_fwd", 1024, 176400, 1764)
    assert t == pytest.approx(max(182 * 1024 * 176400 / 67e12, 4 * (2 * 1024 * 176400 + 1024 * 5 * 1764 + 1024 * 16) / 3.35e12))


def _layer_flops(module, x):
    """{layer name: 2 x its multiply-adds} of every conv and linear of ``module``
    on ``x``, by hand."""
    from portbench.reference import towers as T

    out = {}

    def hook(name):
        def count(m, inp, y):
            w = m.weight
            out[name] = out.get(name, 0) + 2 * y.numel() * w.shape[1] * (w.shape[2] * w.shape[3] if w.dim() == 4 else 1)
        return count

    hooks = [m.register_forward_hook(hook(n)) for n, m in module.named_modules() if isinstance(m, (T.Conv, T.Linear))]
    with torch.no_grad():
        module(*x)
    for h in hooks:
        h.remove()
    return out


def test_model_flops_by_hand():
    from portbench.counts import model_flops
    from portbench.reference import towers as T

    tree = json.loads((HERE / "fixtures" / "configs" / "tiny.json").read_text())["config"]
    b, ta, d = tree["vicreg"]["batch_size"], 14400, tree["embeddim"]
    model = T.VICReg(tree).eval()
    audio, params, rep = torch.zeros(b, 1, ta), torch.zeros(b, 78), torch.zeros(b, tree["dim"])
    pqmf = 2 * (b * 3 * ta // 3) * 63
    layers = _layer_flops(model, (audio, params))
    fwd = sum(layers.values())
    first = layers["backbone_audio.vision_model.stem.conv"] + layers["backbone_param.block1.lin"]
    cov = 2 * (2 * d * d * b)
    # the backward: every layer's weight gradient, every input gradient but the
    # first layers', two operand gradients per covariance product
    assert model_flops.pretrain_step(tree) == pqmf + fwd + cov + (2 * fwd - first) + 2 * cov
    audio_tower = sum(v for k, v in layers.items() if k.startswith("backbone_audio"))
    projector = sum(_layer_flops(model.projector, (rep,)).values())
    head = sum(_layer_flops(T.Head(78, tree["dim"], 0.0), (rep,)).values())
    head_first = 2 * b * tree["dim"] * tree["dim"]
    param_tower = sum(v for k, v in layers.items() if k.startswith("backbone_param"))
    frozen = pqmf + audio_tower + param_tower + 2 * projector
    assert model_flops.downstream_step(tree, "param_mse") == frozen + head + (2 * head - head_first)
    # embedding: the frozen parameter tower and projector again on the
    # prediction, with the input gradients through them
    assert model_flops.downstream_step(tree, "embedding") == (
        frozen + head + (2 * head - head_first) + 2 * (param_tower + projector))
