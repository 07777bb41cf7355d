"""LARS with zero momentum (lightning-flash's rule) and the warm-up cosine schedule.

    local_lr = tc * ||w|| / (||g|| + wd * ||w|| + eps)   where ||w|| > 0 and ||g|| > 0
    update   = -lr * local_lr * (g + wd * w)              (else -lr * g)

with tc 0.001, eps 1e-8, every parameter adapted and decayed, and the peak rate
``batch / 256 * base_lr``. The schedule is a linear warm-up from
``warmup_start_lr`` over ``warmup_epochs`` steps, then a cosine decay to
``eta_min`` at ``max_epochs`` (optax's ``warmup_cosine_decay_schedule``); no
scheduler means a constant rate.
"""

from __future__ import annotations

import math
from typing import List

import torch


def learning_rate(optim_cfg, scheduler_cfg, batch_size: int, count: int) -> float:
    args = optim_cfg["args"]
    peak = batch_size / 256.0 * float(args["base_lr"])
    if not scheduler_cfg or not scheduler_cfg.get("name"):
        return peak
    a = scheduler_cfg["args"]
    warm, total = int(a["warmup_epochs"]), int(a["max_epochs"])
    start, end = float(a.get("warmup_start_lr", 0.0)), float(a.get("eta_min", 0.0))
    if count < warm:
        return start + (peak - start) * count / warm
    c = min(count - warm, total - warm)
    alpha = 0.0 if peak == 0 else end / peak
    return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / (total - warm))) + alpha)


@torch.no_grad()
def lars_step(params: List[torch.Tensor], grads: List[torch.Tensor], lr: float, weight_decay: float,
              tc: float = 0.001, eps: float = 1e-8) -> None:
    for w, g in zip(params, grads):
        if weight_decay == 0.0:
            w.add_(g, alpha=-lr)
            continue
        wn, gn = torch.linalg.vector_norm(w), torch.linalg.vector_norm(g)
        if wn > 0 and gn > 0:
            local = tc * wn / (gn + weight_decay * wn + eps)
            w.add_(-lr * local * (g + weight_decay * w))
        else:
            w.add_(g, alpha=-lr)
