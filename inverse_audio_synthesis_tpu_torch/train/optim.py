"""LARS (lightning-flash's rule, and optax's with momentum), SGD, the LR schedule,
the non-finite guard, and float32 master weights.

Counterpart of the JAX package's ``train/optim.py``:

- ``FusedLars`` is ``fused_lars`` with its non-finite guard (zero momentum, the
  configuration the reference and the CLIs use). flash's formula:

      if wd == 0:                  update = -lr * g                 (plain SGD)
      elif ||w|| > 0 and ||g|| > 0: local_lr = tc*||w|| / (||g|| + wd*||w|| + eps)
                                   update = -lr * local_lr * (g + wd*w)
      else:                        update = -lr * g                 (no decay either)

  A step whose gradient (or weight) norms are not finite applies no update, does
  not advance the schedule count, and adds one to ``total_notfinite`` (the JAX
  package's guard, always on here as in its ``make_optimizer``). Everything stays on the device: no step waits for the host.
- ``MomentumLars`` is ``optax.lars`` with momentum > 0 inside
  ``reject_nonfinite_updates``: decayed weights (masked), the masked trust ratio
  tc*||w|| / (||g + wd*w|| + eps) (1 where either norm is 0), -lr, then
  ``trace(momentum)``. ``Sgd`` is ``optax.sgd``: ``trace(momentum)``, then -lr. A
  rejected step leaves the trace and the count as they were. Momentum is an
  argument of ``make_optimizer`` only, as in JAX: no config key sets it.
- ``Fp32Master`` is ``with_fp32_master`` (``weights_bf16``): the parameters
  stored in bf16 get float32 master copies; the inner optimizer (its norms, the
  guard, the schedule) runs on the masters, and each step writes bf16(master) into
  the stored parameters. float32 parameters are their own masters.
- ``make_schedule``: optax's ``warmup_cosine_decay_schedule`` (linear warmup then
  cosine decay), with ``step_every_nbatches``.
- ``make_optimizer``: LARS with the batch/256 LR scaling, or SGD.
- Under a distributed mesh (``parallel/mesh.py``): ``reduce_gradients`` sums the
  gradients over the data group in float32 as one flat bucket (each rank's
  gradient is its rows' share of the global loss's, so the sum is the whole; see
  ``parallel/collectives.py``), before any bf16 cast, so W ranks round as one
  does. ``||w||`` and ``||g||`` of a tensor the model group splits are taken over
  the group, and all ranks agree on the non-finite flag through one
  ``all_reduce``: a NaN on one rank rejects the step on every rank.

Every tensor of an optimizer is updated in place (a CUDA graph of the train step
holds their addresses). ``state_dict`` names per-parameter state by the
parameter's name (``master.<name>``, ``trace.<name>``), so a checkpoint under
tensor parallelism gathers and splits it as it does the model's.

Plain torch, one small group of ops per parameter tensor; the norms go through
``torch._foreach_norm``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from inverse_audio_synthesis_tpu_torch.models.vicreg import exclude_bias_and_norm as lars_mask
from inverse_audio_synthesis_tpu_torch.parallel.collectives import all_reduce_

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def _as_f32(step, device=None) -> torch.Tensor:
    return torch.as_tensor(step, device=device).to(torch.float32)


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0,
) -> Callable:
    """optax.warmup_cosine_decay_schedule (exponent 1): a linear ramp from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine decay to
    ``end_value`` at ``decay_steps``. Takes an int or a tensor step."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = float(decay_steps - warmup_steps)

    def linear(count):
        if warmup_steps <= 0:
            return torch.full_like(count, init_value)
        c = torch.clamp(count, 0.0, float(warmup_steps))
        frac = 1.0 - c / float(warmup_steps)
        return (init_value - peak_value) * frac + peak_value

    def cosine(count):
        c = torch.clamp_max(count, cos_steps)
        decay = 0.5 * (1.0 + torch.cos(math.pi * c / cos_steps))
        return peak_value * ((1.0 - alpha) * decay + alpha)

    def schedule(step):
        count = _as_f32(step)
        return torch.where(count < warmup_steps, linear(count), cosine(count - warmup_steps))

    return schedule


def make_schedule(scheduler_cfg: Any, peak_lr: float) -> Schedule:
    """A schedule (callable of the step) or the constant ``peak_lr``."""
    if not scheduler_cfg or not scheduler_cfg.get("name"):
        return peak_lr
    name = scheduler_cfg["name"]
    if name != "LinearWarmupCosineAnnealingLR":
        raise ValueError(f"unknown scheduler {name!r}")
    args = scheduler_cfg.get("args", {})
    schedule = warmup_cosine_decay_schedule(
        init_value=float(args.get("warmup_start_lr", 0.0)),
        peak_value=peak_lr,
        warmup_steps=int(args["warmup_epochs"]),
        decay_steps=int(args["max_epochs"]),
        end_value=float(args.get("eta_min", 0.0)),
    )
    step_every = int(scheduler_cfg.get("step_every_nbatches", 1))
    if step_every > 1:
        return lambda step: schedule(torch.div(torch.as_tensor(step), step_every, rounding_mode="floor"))
    return schedule


def schedule_value(schedule: Schedule, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int, or a tensor: then on its device)."""
    if callable(schedule):
        return schedule(step).to(torch.float32)
    device = step.device if isinstance(step, torch.Tensor) else None
    return torch.full((), float(schedule), dtype=torch.float32, device=device)


def reduce_gradients(grads: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """The gradients summed over the data group, in float32, through one flat
    bucket (the gradients unchanged without a process group)."""
    if mesh is None or not mesh.distributed:
        return list(grads)
    bucket = torch.cat([g.reshape(-1).float() for g in grads])
    all_reduce_(bucket, mesh.data_group)
    return [b.view_as(g) for b, g in zip(bucket.split([g.numel() for g in grads]), grads)]


def _agree_finite(isfinite: torch.Tensor, mesh) -> torch.Tensor:
    """True on every rank only when it is true on all of them."""
    if mesh is None or not mesh.distributed:
        return isfinite
    bad = (~isfinite).to(torch.float32).reshape(1)
    all_reduce_(bad, op=dist.ReduceOp.MAX)
    return bad[0] == 0




class _Guarded:
    """What the optimizers share: the parameters and their names, the schedule
    count and the non-finite counter on the device, per-parameter buffers (the
    attributes named in ``buffers``, one tensor per parameter), the in-place step
    and the state dict."""

    buffers: Tuple[str, ...] = ()

    def __init__(self, params: Iterable[torch.Tensor], learning_rate: Schedule, mesh=None,
                 names: Optional[Sequence[str]] = None):
        self.params: List[torch.Tensor] = list(params)
        if not self.params:
            raise ValueError(f"{type(self).__name__} needs at least one parameter")
        self.names = [str(i) for i in range(len(self.params))] if names is None else list(names)
        if len(self.names) != len(self.params):
            raise ValueError(f"{len(self.names)} names for {len(self.params)} parameters")
        self.learning_rate = learning_rate
        self.mesh = mesh
        device = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.total_notfinite = torch.zeros((), dtype=torch.int32, device=device)

    def _advance(self, isfinite: torch.Tensor) -> None:
        """Count the step if it was finite, the rejection if it was not."""
        ok = isfinite.to(torch.int32)
        self.count += ok
        self.total_notfinite += 1 - ok

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        """Apply one update for ``grads`` (one per parameter) in place: the
        subclass's ``updates``, which also advance the count and counter."""
        for p, u in zip(self.params, self.updates(grads)):
            p.add_(u.to(p.dtype))

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The count, the counter and each buffer as ``<buffer>.<parameter name>``."""
        out = {"count": self.count, "total_notfinite": self.total_notfinite}
        for kind in self.buffers:
            out.update({f"{kind}.{n}": t for n, t in zip(self.names, getattr(self, kind))})
        return out

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        self.count.copy_(state["count"])
        self.total_notfinite.copy_(state["total_notfinite"])
        for kind in self.buffers:
            for n, t in zip(self.names, getattr(self, kind)):
                t.copy_(state[f"{kind}.{n}"])


class FusedLars(_Guarded):
    """flash LARS (zero momentum) over a list of parameters, with the non-finite
    guard folded into the norms it already takes."""

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        learning_rate: Schedule,
        weight_decay: float = 0.0,
        trust_coefficient: float = 0.001,
        eps: float = 1e-8,
        exclude_bias_and_norm: bool = False,
        mesh=None,
        split: Optional[Sequence[bool]] = None,
        names: Optional[Sequence[str]] = None,
    ):
        super().__init__(params, learning_rate, mesh, names)
        # per parameter: whether the model group splits it (norms over the group)
        self.split = tuple(split) if split is not None else (False,) * len(self.params)
        self.weight_decay = float(weight_decay)
        self.trust_coefficient = trust_coefficient
        self.eps = eps
        self.exclude_bias_and_norm = exclude_bias_and_norm

    def _masked(self, i: int) -> bool:
        """Whether LARS adapts and decays parameter ``i``: every parameter, or
        with ``exclude_bias_and_norm`` those the model's mask keeps (>= 2 dims)."""
        return not self.exclude_bias_and_norm or lars_mask(self.names[i], self.params[i])

    def _decays(self, i: int) -> bool:
        return self.weight_decay != 0.0 and self._masked(i)

    @torch.no_grad()
    def updates(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The updates for ``grads`` (one per parameter), and the count/guard state
        advanced; the caller adds them to the parameters."""
        lr = schedule_value(self.learning_rate, self.count)
        wd = self.weight_decay
        gf = [g.float() for g in grads]
        g_norm = self._norms(gf, range(len(gf)))
        decayed = [i for i in range(len(self.params)) if self._decays(i)]
        w_norm = {}
        if decayed:
            w_norm = dict(zip(decayed, self._norms([self.params[i].float() for i in decayed], decayed)))
        isfinite = torch.isfinite(torch.stack(list(g_norm) + list(w_norm.values()))).all()
        isfinite = _agree_finite(isfinite, self.mesh)

        out = []
        for i, (g, w) in enumerate(zip(gf, self.params)):
            if i not in w_norm:  # flash's plain-SGD path
                upd = -lr * g
            else:
                wn, gn = w_norm[i], g_norm[i]
                cond = (wn > 0.0) & (gn > 0.0)
                local_lr = torch.where(
                    cond, self.trust_coefficient * wn / (gn + wd * wn + self.eps), 1.0
                )
                # cond false: 1 * (g + 0 * w) == g exactly, flash's undecayed step
                upd = -lr * (local_lr * (g + torch.where(cond, wd, 0.0) * w.float()))
            out.append(torch.where(isfinite, upd, 0.0))
        self._advance(isfinite)
        return out

    def _norms(self, tensors: List[torch.Tensor], index) -> List[torch.Tensor]:
        """L2 norms; those of model-split tensors over the model group."""
        norms = list(torch._foreach_norm(tensors))
        split = [k for k, i in enumerate(index) if self.split[i]]
        if split:
            sq = torch.stack([norms[k] for k in split]) ** 2
            all_reduce_(sq, self.mesh.model_group)
            for k, n in zip(split, torch.sqrt(sq).unbind(0)):
                norms[k] = n
        return norms


class MomentumLars(FusedLars):
    """``optax.lars`` with ``momentum`` > 0 inside the non-finite guard: with the
    mask (every parameter, or those of >= 2 dims with ``exclude_bias_and_norm``),
    u = g + wd*w and u *= tc*||w|| / (||u|| + eps) (1 where either norm is 0);
    then u *= -lr and trace = u + momentum * trace is the update. A rejected step
    applies nothing and leaves the trace and the count as they were."""

    buffers = ("trace",)

    def __init__(self, params: Iterable[torch.Tensor], learning_rate: Schedule, momentum: float,
                 **kwargs):
        super().__init__(params, learning_rate, **kwargs)
        self.momentum = float(momentum)
        self.trace = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def updates(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        lr = schedule_value(self.learning_rate, self.count)
        gf = [g.float() for g in grads]
        isfinite = torch.isfinite(torch.stack(self._norms(gf, range(len(gf))))).all()
        isfinite = _agree_finite(isfinite, self.mesh)
        masked = [i for i in range(len(self.params)) if self._masked(i)]
        u = [torch.where(isfinite, g, 0.0) for g in gf]  # the guard gates the gradients first
        for i in masked:
            u[i] = u[i] + self.weight_decay * self.params[i].float()
        if masked:
            w_norm = self._norms([self.params[i].float() for i in masked], masked)
            u_norm = self._norms([u[i] for i in masked], masked)
            for i, wn, un in zip(masked, w_norm, u_norm):
                ratio = self.trust_coefficient * wn / (un + self.eps)
                u[i] = u[i] * torch.where((wn == 0.0) | (un == 0.0), 1.0, ratio)
        out = []
        for upd, t in zip(u, self.trace):
            new = -lr * upd + self.momentum * t
            t.copy_(torch.where(isfinite, new, t))
            out.append(torch.where(isfinite, new, 0.0))
        self._advance(isfinite)
        return out


class Sgd(_Guarded):
    """``optax.sgd`` with the same guard and interface as FusedLars: trace =
    g + momentum * trace, update = -lr * trace (-lr * g at zero momentum, with no
    trace kept)."""

    def __init__(self, params, learning_rate: Schedule, mesh=None, momentum: float = 0.0,
                 names: Optional[Sequence[str]] = None):
        super().__init__(params, learning_rate, mesh, names)
        self.momentum = float(momentum)
        self.trace = [torch.zeros_like(p) for p in self.params] if self.momentum else []
        self.buffers = ("trace",) if self.momentum else ()

    @torch.no_grad()
    def updates(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        lr = schedule_value(self.learning_rate, self.count)
        gf = [g.float() for g in grads]
        isfinite = _agree_finite(torch.isfinite(torch.stack(torch._foreach_norm(gf))).all(), self.mesh)
        if not self.momentum:
            out = [torch.where(isfinite, -lr * g, 0.0) for g in gf]
        else:
            out = []
            for g, t in zip(gf, self.trace):
                new = torch.where(isfinite, g, 0.0) + self.momentum * t
                t.copy_(torch.where(isfinite, new, t))
                out.append(torch.where(isfinite, -lr * new, 0.0))
        self._advance(isfinite)
        return out


class Fp32Master:
    """``with_fp32_master``: float32 masters of the parameters stored in a
    narrower type (bf16 under ``weights_bf16``), the inner optimizer built over
    the masters by ``make_inner(masters)``, and each step writing the rounded
    masters into the stored parameters in place. A float32 parameter is its own
    master. The state dict adds ``master.<name>`` of each narrower parameter, so a
    checkpoint resumes exactly."""

    def __init__(self, params: Iterable[torch.Tensor], make_inner: Callable[[List[torch.Tensor]], Any],
                 names: Optional[Sequence[str]] = None):
        self.params: List[torch.Tensor] = list(params)
        self.names = [str(i) for i in range(len(self.params))] if names is None else list(names)
        self.narrow = [i for i, p in enumerate(self.params) if p.dtype != torch.float32]
        self.master = [p.detach().float().clone() if i in self.narrow else p
                       for i, p in enumerate(self.params)]
        self.inner = make_inner(self.master)

    @property
    def count(self) -> torch.Tensor:
        return self.inner.count

    @property
    def total_notfinite(self) -> torch.Tensor:
        return self.inner.total_notfinite

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.inner.step(grads)
        for i in self.narrow:
            self.params[i].copy_(self.master[i])

    def state_dict(self) -> Dict[str, torch.Tensor]:
        out = dict(self.inner.state_dict())
        out.update({f"master.{self.names[i]}": self.master[i] for i in self.narrow})
        return out

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        self.inner.load_state_dict(state)
        for i in self.narrow:
            self.master[i].copy_(state[f"master.{self.names[i]}"])


def make_optimizer(
    optim_cfg: Any,
    batch_size: int,
    params: Iterable[torch.Tensor],
    scheduler_cfg: Any = None,
    mesh=None,
    split: Optional[Sequence[bool]] = None,
    momentum: float = 0.0,
    names: Optional[Sequence[str]] = None,
) -> Tuple[Any, Schedule]:
    """The optimizer named by the config over ``params``. Returns (optimizer,
    schedule). A step with a non-finite gradient is rejected on the device and
    counted in ``optimizer.total_notfinite``; the Trainer raises on it.
    ``batch_size`` is the global batch; ``split`` flags the parameters ``mesh``'s
    model group splits; ``names`` (the parameters' names) key per-parameter
    state in the state dict."""
    name = optim_cfg["name"]
    args = optim_cfg.get("args", {})
    if name == "lars":
        peak_lr = batch_size / 256.0 * float(args["base_lr"])
        schedule = make_schedule(scheduler_cfg, peak_lr)
        kwargs = dict(
            weight_decay=float(args.get("weight_decay", 0.0)),
            trust_coefficient=0.001,
            eps=1e-8,
            exclude_bias_and_norm=bool(args.get("exclude_bias_and_norm", False)),
            mesh=mesh,
            split=split,
            names=names,
        )
        if momentum:
            return MomentumLars(params, schedule, momentum, **kwargs), schedule
        return FusedLars(params, schedule, **kwargs), schedule
    if name == "sgd":
        schedule = make_schedule(scheduler_cfg, float(args["lr"]))
        return Sgd(params, schedule, mesh=mesh, momentum=momentum, names=names), schedule
    raise ValueError(f"unknown optimizer {name!r}")
