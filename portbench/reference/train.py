"""Reference training steps: VICReg pretraining and the downstream head.

Each follows the measured program's first steps from the same weights, batch
numbers and dropout seed, and returns per step the loss and its components,
the first step's embeddings (pretraining) or predictions (downstream), the
gradient of every parameter at the first step, and the parameters after the
last. BatchNorm statistics update in train mode as the program's do; the
dropout masks are drawn from a generator seeded as the program seeds its own
(the run's seed + 1 for the parameter tower, + 2 for the head), in the order
the forward pass meets them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import synth as S
from . import towers as T
from .lars import lars_step, learning_rate
from .mel import MelSpectrogram


def _load(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    missing, unexpected = module.load_state_dict(weights, strict=False)
    params = {n for n, _ in module.named_parameters()}
    if params & set(missing) or unexpected:
        raise KeyError(f"weights do not fit the reference: missing {sorted(params & set(missing))[:5]}, "
                       f"unexpected {unexpected[:5]}")


def _dropout_generator(module, seed: int, device) -> None:
    gen = torch.Generator(device=device).manual_seed(seed)
    for m in module.modules():
        if isinstance(m, T.Dropout):
            m.generator = gen


def _rounded(grads):
    """The gradients of the matrices and kernels as the precision stores them."""
    return [T.rounded_gradient(g) if g.dim() >= 2 else g for g in grads]


class _Bf16(torch.autograd.Function):
    """bfloat16 in the forward pass and for the gradient in the backward."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def _stage_round(x: torch.Tensor, low: bool) -> torch.Tensor:
    """A float32 stage's tensor, or in the control that stage's next precision
    down, bfloat16."""
    return _Bf16.apply(x) if low else x


def pretrain(cfg, weights: Dict[str, torch.Tensor], batch_nums: List[int], device) -> Dict:
    """The VICReg steps for ``batch_nums`` from ``weights`` (name -> tensor)."""
    v = cfg["vicreg"]
    synth = S.synth_from_cfg(cfg, v["batch_size"])
    noise = S.noise_rows(synth, synth.batch_size, device)
    model = T.VICReg(cfg).to(device)
    _load(model, weights)
    _dropout_generator(model, int(cfg["seed"]) + 1, device)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    out = {"loss": [], "repr_loss": [], "std_loss": [], "cov_loss": []}
    for count, n in enumerate(batch_nums):
        model.train()
        params01 = S.voice_params(n, synth, device)
        audio = S.render_blocks(params01, synth, noise)
        x, y = model(audio[:, None, :], params01)
        if count == 0:
            out["embed"] = [x.detach().float().cpu(), y.detach().float().cpu()]
        loss, r, s, c = T.vicreg_loss(x, y, v["sim_coeff"], v["std_coeff"], v["cov_coeff"])
        grads = _rounded(torch.autograd.grad(loss, params))
        if count == 0:
            out["grad"] = {nm: g.detach().clone() for nm, g in zip(names, grads)}
        for key, val in zip(("loss", "repr_loss", "std_loss", "cov_loss"), (loss.detach(), r, s, c)):
            out[key].append(float(val))
        lr = learning_rate(v["optim"], v.get("scheduler"), v["batch_size"], count)
        lars_step(params, list(grads), lr, float(v["optim"]["args"].get("weight_decay", 0.0)))
    out["params"] = {nm: p.detach() for nm, p in zip(names, params)}
    return out


def downstream(cfg, tower_weights: Dict[str, torch.Tensor], head_weights: Dict[str, torch.Tensor],
               batch_nums: List[int], device, rows: int = 128) -> Dict:
    """The head's steps for ``batch_nums`` on frozen eval-mode towers. The
    grad-through-synth term is taken ``rows`` voices at a time: its gradient
    with respect to the predicted parameters is summed block by block, then
    carried through the head with the other terms."""
    a = cfg["audio_to_params"]
    kind = a.get("loss", "embedding")
    weights = dict(a.get("loss_weights") or {}) if kind == "combined" else {kind: 1.0}
    weights = {k: float(w) for k, w in weights.items() if w}
    synth = S.synth_from_cfg(cfg, a["batch_size"])
    noise = S.noise_rows(synth, synth.batch_size, device)
    frozen = T.VICReg(cfg).to(device).eval().requires_grad_(False)
    _load(frozen, tower_weights)
    head = T.Head(cfg["nparams"], cfg["dim"], a["dropout"]).to(device)
    _load(head, head_weights)
    _dropout_generator(head, int(cfg["seed"]) + 2, device)
    m = cfg["mel"]
    mel = MelSpectrogram(cfg["torchsynth"]["rate"], m["n_fft"], m["hop_length"], m["n_mels"],
                         m["norm"], m["mel_scale"], m["power"], device)
    names = [n for n, _ in head.named_parameters()]
    params = [p for _, p in head.named_parameters()]
    out = {"loss": [], **{k: [] for k in weights}}
    b = synth.batch_size
    for count, n in enumerate(batch_nums):
        head.train()
        params01 = S.voice_params(n, synth, device)
        audio = S.render_blocks(params01, synth, noise, rows)
        with torch.no_grad():
            audio_repr = torch.cat([frozen.backbone_audio(audio[i:i + rows, None, :]) for i in range(0, b, rows)])
        pred = head(audio_repr)
        if count == 0:
            out["pred"] = pred.detach().float().cpu()
        terms = {}
        if "param_mse" in weights:
            terms["param_mse"] = torch.mean((pred - params01) ** 2)
        if "embedding" in weights:
            with torch.no_grad():
                true_emb = frozen.projector(frozen.backbone_param(params01))
            terms["embedding"] = torch.mean((true_emb - frozen.projector(frozen.backbone_param(pred))) ** 2)
        surrogate = sum(weights[k] * v for k, v in terms.items())
        if "mel_l1" in weights:
            leaf = pred.detach().requires_grad_(True)
            total = 0.0
            for i in range(0, b, rows):
                spec = mel(torch.stack([S.render(leaf[i:i + rows], synth, noise[i:i + rows]), audio[i:i + rows]]))
                part = torch.sum(torch.abs(spec[0] - spec[1])) / (b * spec[0][0].numel())
                part.backward()
                total += float(part)
            terms["mel_l1"] = total
            surrogate = surrogate + weights["mel_l1"] * torch.sum(pred * leaf.grad)
        grads = _rounded(torch.autograd.grad(surrogate, params))
        if count == 0:
            out["grad"] = {nm: g.detach().clone() for nm, g in zip(names, grads)}
        loss = sum(weights[k] * float(v) for k, v in terms.items())
        out["loss"].append(loss)
        for k, v in terms.items():
            out[k].append(float(v))
        lr = learning_rate(a["optim"], a.get("scheduler"), a["batch_size"], count)
        lars_step(params, list(grads), lr, float(a["optim"]["args"].get("weight_decay", 0.0)))
    out["params"] = {nm: p.detach() for nm, p in zip(names, params)}
    return out


def downstream_first_step(cfg, tower_weights: Dict[str, torch.Tensor], batch_num: int, pred: torch.Tensor,
                          device, rows: int = 128, low: bool = False,
                          head_weights: Optional[Dict[str, torch.Tensor]] = None,
                          pred_grad: Optional[torch.Tensor] = None) -> Dict:
    """The first downstream step's stages from the program's own predicted
    parameters ``pred`` [B, 78]: the frozen towers' VICReg loss of the true
    pair (which no prediction enters), and the objective and its gradient with
    respect to ``pred`` (the render of the predictions, the mel term, the other
    terms). With ``head_weights`` and the program's gradient at its
    predictions ``pred_grad``, also the head's backward (``head_grads``): the
    head from those weights, on this batch's representation, with the first
    step's dropout masks, carries ``pred_grad`` back to each parameter.
    ``low``: the control, each float32 stage (render, mel, the objective's
    gradient) in bfloat16, the towers and the head at their precision."""
    a = cfg["audio_to_params"]
    kind = a.get("loss", "embedding")
    weights = dict(a.get("loss_weights") or {}) if kind == "combined" else {kind: 1.0}
    weights = {k: float(w) for k, w in weights.items() if w}
    synth = S.synth_from_cfg(cfg, a["batch_size"])
    noise = S.noise_rows(synth, synth.batch_size, device)
    frozen = T.VICReg(cfg).to(device).eval().requires_grad_(False)
    _load(frozen, tower_weights)
    b = synth.batch_size
    params01 = S.voice_params(batch_num, synth, device)
    audio = S.render_blocks(params01, synth, noise, rows)
    with torch.no_grad():
        repr_ = torch.cat([frozen.backbone_audio(audio[i:i + rows, None, :]) for i in range(0, b, rows)])
        true_emb = frozen.projector(frozen.backbone_param(params01))
        frozen_loss = float(torch.mean((true_emb - frozen.projector(repr_)) ** 2))
    leaf = pred.to(device).float().requires_grad_(True)
    total = 0.0
    if "param_mse" in weights:
        term = weights["param_mse"] * torch.mean((_stage_round(leaf, low) - params01) ** 2)
        term.backward()
        total += float(term)
    if "embedding" in weights:
        term = weights["embedding"] * torch.mean((true_emb - frozen.projector(frozen.backbone_param(leaf))) ** 2)
        term.backward()
        total += float(term)
    if "mel_l1" in weights:
        m = cfg["mel"]
        mel = MelSpectrogram(cfg["torchsynth"]["rate"], m["n_fft"], m["hop_length"], m["n_mels"],
                             m["norm"], m["mel_scale"], m["power"], device)
        for i in range(0, b, rows):
            pred_audio = _stage_round(S.render(leaf[i:i + rows], synth, noise[i:i + rows], strict_masks=True), low)
            spec = _stage_round(mel(torch.stack([pred_audio, audio[i:i + rows]])), low)
            part = weights["mel_l1"] * torch.sum(torch.abs(spec[0] - spec[1])) / (b * spec[0][0].numel())
            part.backward()
            total += float(part)
    grad = leaf.grad.to(torch.bfloat16).float() if low else leaf.grad
    out = {"frozen": frozen_loss, "objective": total, "pred_grad": grad.cpu()}
    if head_weights is not None:
        head = T.Head(cfg["nparams"], cfg["dim"], a["dropout"]).to(device)
        _load(head, head_weights)
        _dropout_generator(head, int(cfg["seed"]) + 2, device)
        head.train()
        names = [n for n, _ in head.named_parameters()]
        params = [p for _, p in head.named_parameters()]
        grads = _rounded(torch.autograd.grad(head(repr_), params, grad_outputs=pred_grad.to(device).float()))
        out["head_grads"] = dict(zip(names, grads))
    return out


@torch.no_grad()
def lars_update(before: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], lr: float, weight_decay: float,
                low: bool = False) -> Dict[str, torch.Tensor]:
    """The change one LARS step makes to ``before`` from ``grads`` (host
    tensors); ``low``: the control, in bfloat16."""
    r = (lambda t: t.to(torch.bfloat16).float()) if low else (lambda t: t)
    params = {n: r(w.clone()) for n, w in before.items()}
    lars_step(list(params.values()), [r(grads[n]) for n in params], lr, weight_decay)
    return {n: r(params[n] - r(before[n])) for n in params}
