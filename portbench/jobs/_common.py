"""What the job drivers share: the program's configuration from the cell's
tree, the Trainer's feed of consecutive batch numbers, a recording stand-in
for the task, and the first gradient as the optimizer receives it."""

from __future__ import annotations

import copy
import random
import time
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional

import torch


def program_config(tree: Dict[str, Any], traffic: Dict[str, Any], seed: int, device):
    """The port's Config: the configuration tree, the traffic's dotted
    ``overrides``, the run's seed, and ``platform=cpu`` off the card."""
    from inverse_audio_synthesis_tpu_torch.utils.config import Config

    cfg = Config(copy.deepcopy(tree))
    for key, value in traffic.get("overrides", {}).items():
        cfg.set_dotted(key, value)
    cfg.seed = int(seed)
    cfg.platform = None if torch.device(device).type == "cuda" else "cpu"
    return cfg


def reference_tree(tree: Dict[str, Any], traffic: Dict[str, Any], seed: int) -> Dict[str, Any]:
    """The same configuration as a plain tree, for the reference."""
    out = copy.deepcopy(tree)
    for key, value in traffic.get("overrides", {}).items():
        node = out
        *parents, last = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = value
    out["seed"] = int(seed)
    return out


def first_batch_number(seed: int) -> int:
    """Where a run's consecutive batch numbers start."""
    return random.Random(int(seed)).randrange(1 << 24)


class ConsecutiveSplit:
    """The Trainer's feed: training batch numbers start, start + 1, ..."""

    def __init__(self, start: int):
        self.start = start
        self.sizes = SimpleNamespace(train=1 << 40, val=0, test=0)

    def train_batch_num(self, i: int) -> int:
        return self.start + i


class RecordingTask:
    """The task, with the named metrics of every train step kept (device
    tensors, in order): what the loop's own calls return. ``keys`` maps a
    short name to the metric's key."""

    def __init__(self, task, keys: Dict[str, str]):
        self._task, self._keys = task, keys
        self.values: Dict[str, List[torch.Tensor]] = {k: [] for k in keys}

    def __getattr__(self, name):
        return getattr(self._task, name)

    def _keep(self, metrics) -> None:
        for short, key in self._keys.items():
            if key in metrics:
                self.values[short].append(metrics[key].reshape(-1).float())

    def train_step(self, state, batch_num):
        state, metrics = self._task.train_step(state, batch_num)
        self._keep(metrics)
        return state, metrics

    def train_step_multi(self, state, batch_nums):
        state, metrics = self._task.train_step_multi(state, batch_nums)
        self._keep(metrics)
        return state, metrics

    def series(self) -> Dict[str, List[float]]:
        """short name -> that metric at each recorded step, for those recorded."""
        return {k: torch.cat(v).tolist() for k, v in self.values.items() if v}


def record_first_gradient(optimizer, names: List[str], full: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """Until the next step: keep the norm of each gradient the optimizer is
    handed (``norm``: name -> 0-dim device tensor), then stop recording. With
    ``full`` also keep host copies of the gradients (``grad``) and of the
    parameters before and after that step (``before``, ``after``)."""
    kept: Dict[str, Dict[str, torch.Tensor]] = {"norm": {}, "grad": {}, "before": {}, "after": {}}

    def host(tensors):
        return {n: t.detach().float().cpu().clone() for n, t in zip(names, tensors)}

    def step(grads):
        del optimizer.step  # the class's own step again
        kept["norm"] = {n: torch.linalg.vector_norm(g.float()) for n, g in zip(names, grads)}
        if full:
            kept["grad"], kept["before"] = host(grads), host(optimizer.params)
        out = optimizer.step(grads)
        if full:
            kept["after"] = host(optimizer.params)
        return out

    optimizer.step = step
    return kept


def norms_of(kept: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """name -> float of ``record_first_gradient``'s norms, in one transfer."""
    return dict(zip(kept, torch.stack(list(kept.values())).tolist()))


def record_first_output(module: torch.nn.Module, calls: int = 1) -> Dict[str, object]:
    """At the module's next ``calls`` forwards: keep each output (``outputs``)
    and, once the backward has run, the gradient of the loss with respect to
    the first (``grad``); host copies, float32."""
    kept: Dict[str, object] = {"outputs": []}

    def forward_hook(mod, args, out):
        kept["outputs"].append(out.detach().float().cpu().clone())
        if len(kept["outputs"]) == 1 and out.requires_grad:
            out.register_hook(lambda g: kept.__setitem__("grad", g.detach().float().cpu().clone()))
        if len(kept["outputs"]) == calls:
            handle.remove()

    handle = module.register_forward_hook(forward_hook)
    return kept


def change_norms(module: torch.nn.Module, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = [n for n, _ in module.named_parameters()]
    params = dict(module.named_parameters())
    values = torch.stack([torch.linalg.vector_norm(params[n].detach().float() - start[n]) for n in names])
    return dict(zip(names, values.tolist()))


def aligned(i: int, log_every: int) -> int:
    """The first step index >= i at which a fit's first (single, eager) step
    ends on a log boundary, so that its later dispatches are those of a fit
    running since step 0: graphs of the configured length, clamped at each
    boundary."""
    return i + (-(i + 1)) % log_every


class _WindowEnd(Exception):
    """Raised out of the training loop at the window's end."""


class _Units:
    """The task, with a look after each dispatch has been enqueued: the window
    ends at the first dispatch's end past ``seconds``, or where ``on_unit``
    (handed each dispatch's record) answers True. It ends by ``_WindowEnd``
    out of the loop, once the task has updated the state in place."""

    def __init__(self, task, seconds: float, on_unit: Optional[Callable[[Dict], bool]], batch: int):
        self._task, self._on_unit, self._batch = task, on_unit, batch
        self._deadline = time.perf_counter() + seconds

    def __getattr__(self, name):
        return getattr(self._task, name)

    def _after(self, steps: int) -> None:
        record = {"attempted": steps, "steps": steps, "voices": steps * self._batch}
        stop = self._on_unit is not None and self._on_unit(record)
        if stop or time.perf_counter() >= self._deadline:
            raise _WindowEnd

    def train_step(self, state, batch_num):
        out = self._task.train_step(state, batch_num)
        self._after(1)
        return out

    def train_step_multi(self, state, batch_nums):
        out = self._task.train_step_multi(state, batch_nums)
        self._after(len(batch_nums))
        return out


def fit_for(trainer, state, start: int, seconds: float, on_unit: Optional[Callable[[Dict], bool]] = None,
            batch: int = 0):
    """One ``Trainer.fit`` from step index ``start`` that ends after the first
    dispatch past ``seconds``, or after the one at which ``on_unit`` answers
    True (``_Units``). The task updates the state in place, so the state is
    whole when the loop is left (no checkpoint is set, so nothing is written).
    Returns (state, steps done)."""
    trainer.limit_train_batches = None
    task = trainer.task
    trainer.task = _Units(task, seconds, on_unit, batch)
    before = state.step
    try:
        trainer.fit(state, start)
    except _WindowEnd:
        pass
    finally:
        trainer.task = task
    return state, state.step - before
