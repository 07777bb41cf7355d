"""Runs that a world of ranks and one rank both make, to be held against each other.

Each function runs the same steps from the same seed through the port's entry
points, and returns plain tensors and numbers: on one process without a
process group (the reference), or on each rank of a world that
``parallel/launch.py:spawn_world`` started. ``tests/test_torch_port_parallel*.py``
and ``chip_smoke.py`` call them; they live in the package so that a spawned rank
imports torch and the port only.

What a run returns, besides its metrics: rank 0's full (unsharded) parameters
after its steps and the full gradient its first step handed the optimizer
(every rank's per-tensor sums of the parameters, to show the replicas agree),
the rank's rows of K1's audio and K2's cotangents for its first batch
(``render_rows``), the launches of each kernel (and downstream, the train
step's synth replays and eager calls), the ``all_reduce`` calls and bytes per
train step, and its peak device memory.
"""

from __future__ import annotations

import os
import signal
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from inverse_audio_synthesis_tpu_torch.eval.retrieval import RetrievalEvaluator
from inverse_audio_synthesis_tpu_torch.models.jax_weights import export_jax_variables, load_jax_variables
from inverse_audio_synthesis_tpu_torch.models.layers import BatchNorm
from inverse_audio_synthesis_tpu_torch.models.vicreg import Projector
from inverse_audio_synthesis_tpu_torch.ops import launches
from inverse_audio_synthesis_tpu_torch.ops import render as R
from inverse_audio_synthesis_tpu_torch.parallel import collectives as C
from inverse_audio_synthesis_tpu_torch.parallel.mesh import (
    apply_mesh,
    create_mesh,
    full_state_dict,
    split_dim,
)
from inverse_audio_synthesis_tpu_torch.synth import modules, prng
from inverse_audio_synthesis_tpu_torch.synth.voice import (
    compute_controls,
    fused_scalars,
    sample_voice_params,
)
from inverse_audio_synthesis_tpu_torch.train.checkpoint import CheckpointManager
from inverse_audio_synthesis_tpu_torch.train.downstream import AudioToParamsTask
from inverse_audio_synthesis_tpu_torch.train.loop import Trainer
from inverse_audio_synthesis_tpu_torch.train.optim import reduce_gradients
from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask, synth_config_from_cfg
from inverse_audio_synthesis_tpu_torch.train.runsetup import BatchNumberSplit
from inverse_audio_synthesis_tpu_torch.utils.config import load_config

Result = Dict[str, Any]


def _numbers(metrics: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (v.detach().float().cpu() if v.dim() else float(v)) if isinstance(v, torch.Tensor)
            else float(v) for k, v in metrics.items()}


def _setup(tf32: Optional[bool]) -> None:
    """TF32 on or off for both matmuls and cuDNN; None leaves torch's defaults."""
    if tf32 is not None:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset(device: torch.device) -> None:
    _sync(device)
    launches.reset()
    C.reset_all_reduce_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _per_step(n_steps: int) -> Dict[str, float]:
    """``all_reduce`` calls and bytes per train step since ``_reset``."""
    return {k: v / n_steps for k, v in C.all_reduce_counts.items()}


def _counts(device: torch.device) -> Result:
    """Kernel launches and peak device memory since ``_reset``."""
    _sync(device)
    return {
        "launches": dict(R.launch_counts),
        "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0,
    }


def _params(model, mesh) -> Result:
    """Rank 0's full parameters and buffers; every rank's per-tensor sums."""
    full = full_state_dict(model, mesh)
    return {
        "params": full if mesh.rank == 0 else None,
        "digest": {k: float(v.double().sum()) for k, v in full.items()},
    }


@contextmanager
def _recorded_gradients(optimizer):
    """Inside: the gradients ``optimizer.step`` is handed at its first step
    (reduced over the data group, this rank's shards) go into the list yielded."""
    seen: List[List[torch.Tensor]] = []
    step = optimizer.step

    def recording(grads):
        if not seen:
            seen.append([g.detach().float().clone() for g in grads])
        step(grads)

    optimizer.step = recording
    try:
        yield seen
    finally:
        del optimizer.step  # the class's method again, and no reference cycle


def _full_gradients(model, grads: Sequence[torch.Tensor], mesh) -> Optional[Dict[str, torch.Tensor]]:
    """Rank 0's full gradients by parameter name (split ones gathered)."""
    out = {}
    for (name, _), g in zip(model.named_parameters(), grads):
        dim = split_dim(name) if mesh.tensor_parallel else None
        out[name] = (C.gather_shard(g, dim, mesh) if dim is not None else g).cpu()
    return out if mesh.rank == 0 else None


def _identity(task) -> Result:
    mesh = task.mesh
    return {"rank": mesh.rank, "rows": (task.rows.start, task.rows.stop),
            "backend": dist.get_backend() if dist.is_initialized() else None}


def render_rows(task, batch_num: int, cotangent_seed: int = 7) -> Optional[Result]:
    """K1's audio and K2's d_routed and d_scalars for the task's rows of a batch,
    from its own noise rows and a position-keyed cotangent (the global batch's
    rows, so they compare bit for bit with a one-rank run). None when the
    geometry does not take the fused render."""
    if not task.voices.fused_render:
        return None
    with torch.no_grad():
        params01 = sample_voice_params(batch_num, task.synth, task.device)[task.rows]
        p, routed, midi_f0 = compute_controls(params01, task.synth)
        routed, scalars = routed.contiguous(), fused_scalars(p, midi_f0).contiguous()
        sr = float(task.synth.sample_rate)
        audio, seg_mean, offset = R.render_audio_fused(routed, scalars, task.voices.noise, sr, save_phase=True)
        g = modules.noise(prng.prng_key(cotangent_seed), routed.shape[0], task.synth.buffer_size,
                          device=task.device, row_offset=task.rows.start)
        d_routed, d_scalars = R.render_audio_fused_bwd(routed, scalars, task.voices.noise, g, seg_mean, offset, sr)
    return {"audio": audio.cpu(), "d_routed": d_routed.cpu(), "d_scalars": d_scalars.cpu(),
            "noise_row_sums": task.voices.noise.double().sum(1).cpu()}


def pretrain(overrides: Sequence[str], batch_nums: Sequence[int] = (7,), val_batch: Optional[int] = 11,
             tf32: Optional[bool] = False, keep_init: bool = False, variables: Optional[Dict] = None,
             params_after: Optional[int] = None) -> Result:
    """VICReg train steps on ``batch_nums``, then a val step. The parameters
    returned are those after ``params_after`` steps (default: all of them).
    ``variables``: a JAX variable tree to start from (numpy leaves); the result
    then also holds ``jax_after``, the tree after the steps (rank 0)."""
    _setup(tf32)
    task = VicregPretrainTask(load_config(overrides=list(overrides)))
    state = task.init_state()
    if variables is not None:
        load_jax_variables(state.model, variables, task.mesh)
    out = {**_identity(task), "init": full_state_dict(state.model, task.mesh) if keep_init else None}
    out["kernels"] = render_rows(task, batch_nums[0])
    _reset(task.device)
    metrics, step_s = [], []
    params_after = len(batch_nums) if params_after is None else params_after
    with _recorded_gradients(state.optimizer) as grads:
        for i, b in enumerate(batch_nums):
            t0 = time.perf_counter()
            state, m = task.train_step(state, b)
            _sync(task.device)
            step_s.append(time.perf_counter() - t0)
            metrics.append(_numbers(m))
            if i + 1 == params_after:  # its gathers are not the step's
                counts = dict(C.all_reduce_counts)
                snapshot = _params(state.model, task.mesh)
                C.all_reduce_counts.update(counts)
    out["all_reduce_per_step"] = _per_step(len(batch_nums))
    val = _numbers(task.val_step(state, val_batch)) if val_batch is not None else None
    out.update(_counts(task.device), metrics=metrics, val=val, step_s=step_s,
               grads=_full_gradients(state.model, grads[0], task.mesh), **snapshot)
    if variables is not None:
        out["jax_after"] = _jax_tree(state.model, variables, task.mesh)
    return out


def _jax_tree(model, like, mesh) -> Optional[Dict]:
    tree = export_jax_variables(model, like, mesh)
    return tree if mesh.rank == 0 else None


def downstream(overrides: Sequence[str], batch_num: int = 7, test_batch: int = 99,
               tf32: Optional[bool] = False, keep_init: bool = False, tower_variables: Optional[Dict] = None,
               head_variables: Optional[Dict] = None, perturb_repr: bool = False) -> Result:
    """A test step on random towers from the seed (or the JAX
    ``tower_variables``) and the initial head, one downstream train step, then a
    test step again. With ``head_variables`` (a JAX tree) the head starts from
    them and ``jax_after`` holds its tree after the step. ``perturb_repr``
    moves each value of the frozen audio representation by one float32 ulp
    (a rounding-size change of the head's input, to measure the step's
    conditioning)."""
    _setup(tf32)
    cfg = load_config(overrides=list(overrides))
    pre = VicregPretrainTask(cfg)
    towers = pre.init_state()
    if tower_variables is not None:
        load_jax_variables(towers.model, tower_variables, pre.mesh)
    task = AudioToParamsTask(cfg, pre, towers)
    state = task.init_state()
    if head_variables is not None:
        load_jax_variables(state.model, head_variables, task.mesh)
    if perturb_repr:
        audio_repr = task._audio_repr

        def nudged(audio):
            r = audio_repr(audio)
            return torch.nextafter(r, torch.full_like(r, float("inf")))

        task._audio_repr = nudged
    out = {**_identity(task), "init": full_state_dict(state.model, task.mesh) if keep_init else None}
    out["kernels"] = render_rows(task, batch_num)
    _reset(task.device)
    test_init, _, _ = task.test_step(state, test_batch)
    _sync(task.device)
    C.reset_all_reduce_counts()
    t0 = time.perf_counter()
    with _recorded_gradients(state.optimizer) as grads:
        state, m = task.train_step(state, batch_num)
    _sync(task.device)
    step_s = time.perf_counter() - t0
    out["all_reduce_per_step"] = _per_step(1)
    test, _, _ = task.test_step(state, test_batch)
    out.update(_counts(task.device), synth_calls=dict(task.synth_calls), metrics=_numbers(m),
               test_init=_numbers(test_init), test=_numbers(test), step_s=[step_s],
               grads=_full_gradients(state.model, grads[0], task.mesh), **_params(state.model, task.mesh))
    if head_variables is not None:
        out["jax_after"] = _jax_tree(state.model, head_variables, task.mesh)
    return out


def retrieval(overrides: Sequence[str], batch_nums: Sequence[int] = (3, 5), n_queries: int = 4,
              n_candidates: int = 8, inner_chunk: int = 4, linear_embedding: bool = False,
              tf32: Optional[bool] = False) -> Result:
    """Retrieval chunk steps on ``batch_nums``: the towers' projected embedding,
    or a numpy linear map of the audio (seed 1) where the towers collapse."""
    _setup(tf32)
    cfg = load_config(overrides=list(overrides))
    task = VicregPretrainTask(cfg)
    state = task.init_state()
    query, candidate = synth_config_from_cfg(cfg, n_queries), synth_config_from_cfg(cfg, n_candidates)
    if linear_embedding:
        t = candidate.buffer_size
        w = torch.from_numpy((np.random.RandomState(1).randn(t, 16) / np.sqrt(t)).astype(np.float32))
        w = w.to(task.device)

        def embed(audio):
            return audio[:, 0, :] @ w
    else:
        def embed(audio):
            return task.project_audio(state, audio)
    _reset(task.device)
    ev = RetrievalEvaluator(embed, query, candidate, inner_chunk=inner_chunk, device=task.device,
                            mesh=task.mesh)
    step_s = []
    for b in batch_nums:
        t0 = time.perf_counter()
        ev.step(b)
        step_s.append(time.perf_counter() - t0)
    out = {"rank": task.mesh.rank, "best_dist": ev.best_dist.cpu(), "best_params": ev.best_params.cpu(),
           "best_audio": ev.best_audio.cpu(), "step_s": step_s, "all_reduce_per_step": _per_step(len(batch_nums))}
    out.update(_counts(task.device))
    return out


def rejected_step(overrides: Sequence[str], nan_rank: int, batch_num: int = 7) -> Result:
    """One train step whose gradient is NaN on rank ``nan_rank`` only (a hook on
    the first parameter): whether the step was applied, and the counters."""
    task = VicregPretrainTask(load_config(overrides=list(overrides)))
    state = task.init_state()
    params = list(state.model.parameters())
    if task.mesh.rank == nan_rank:
        params[0].register_hook(lambda g: g * float("nan"))
    before = [p.detach().clone() for p in params]
    state, _ = task.train_step(state, batch_num)
    return {
        "rank": task.mesh.rank,
        "changed": any(not torch.equal(a, p) for a, p in zip(before, params)),
        "count": int(state.optimizer.count),
        "total_notfinite": int(state.optimizer.total_notfinite),
    }


def preempted(overrides: Sequence[str], directory: str, signal_rank: int, at_step: int = 1,
              n_steps: int = 4) -> Result:
    """``Trainer.fit`` over ``n_steps`` with checkpoints in ``directory``, where
    rank ``signal_rank`` alone receives SIGTERM during step ``at_step``: the
    step each rank stopped at, its signal, and the checkpoint written."""
    cfg = load_config(overrides=list(overrides))
    task = VicregPretrainTask(cfg)
    state = task.init_state()
    manager = CheckpointManager(directory, mesh=task.mesh)
    trainer = Trainer(task, BatchNumberSplit(100, 1, cfg.seed), checkpoint=manager,
                      limit_train_batches=n_steps, log_every=1)
    if task.mesh.rank == signal_rank:
        step = task.train_step

        def step_then_signal(state, batch_num):
            out = step(state, batch_num)
            if out[0].step == at_step:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        task.train_step = step_then_signal
    state = trainer.fit(state)
    return {"rank": task.mesh.rank, "step": state.step, "interrupted": trainer.interrupted,
            "saved": manager.latest_step()}


def checkpoint(overrides: Sequence[str], directory: str, save: bool, batch_num: int = 7) -> Result:
    """``save``: one train step, then a checkpoint of step 1 in ``directory``.
    Otherwise a fresh state restored from it. Returns rank 0's full parameters."""
    task = VicregPretrainTask(load_config(overrides=list(overrides)))
    state = task.init_state()
    manager = CheckpointManager(directory, mesh=task.mesh)
    if save:
        state, _ = task.train_step(state, batch_num)
        manager.save(state, 1)
        manager.latest_step()  # the write committed before any rank reads
    else:
        state = manager.restore(state)
    return {"rank": task.mesh.rank, "step": state.step, "count": int(state.optimizer.count),
            **_params(state.model, task.mesh)}


def run_all(calls: Sequence[Tuple[str, Dict[str, Any]]]) -> List[Result]:
    """Several of these runs in one world, in order: (function name, kwargs)."""
    return [globals()[name](**kwargs) for name, kwargs in calls]


def collectives(meshes: Sequence[Sequence[int]] = ((1, 1),), seed: int = 0) -> List[Result]:
    """``_collectives`` on each (data, model) mesh, in order."""
    return [_collectives(data, model, seed) for data, model in meshes]


def _collectives(data: int, model: int, seed: int) -> Result:
    """The collectives on small tensors made from ``seed`` with numpy, for a test
    to hold against one process: ``gather_rows`` forward and backward, BatchNorm
    (train mode, running statistics) on the data group's rows, and the
    projector (tensor-parallel, the Megatron pair, under ``model > 1``) with the
    gradients of its input and its full parameters."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(8, 6).astype(np.float32))
    w = torch.from_numpy(rng.randn(8, 6).astype(np.float32))
    img = torch.from_numpy(rng.randn(8, 3, 4, 5).astype(np.float32) * 2 + 1)
    mesh = create_mesh(data, model)
    rows = mesh.local_rows(8)
    out: Result = {}

    xl = x[rows].clone().requires_grad_()
    y = C.gather_rows(xl, mesh)
    (gx,) = torch.autograd.grad(torch.sum(y * w), xl)
    out.update(gathered=y.detach(), gather_grad=gx)

    bn = apply_mesh(torch.nn.Sequential(BatchNorm(3, eps=1e-3, momentum=0.9)), mesh)
    il = img[rows].clone().requires_grad_()
    z = bn(il)
    loss = C.global_sum(torch.sum(z * z * torch.arange(1.0, 4.0)[None, :, None, None]), mesh)
    grads = torch.autograd.grad(loss, [il, *bn.parameters()])
    out.update(bn_out=z.detach(), bn_grad_x=grads[0],
               bn_grads=reduce_gradients(grads[1:], mesh), bn_running=dict(bn.state_dict()))

    torch.manual_seed(seed)
    proj = torch.nn.Module()
    proj.projector = Projector((6, 8, 8, 4))
    apply_mesh(proj, mesh)
    xp = x[rows].clone().requires_grad_()
    e = C.gather_rows(proj.projector(xp), mesh)
    loss = torch.sum(e * e)
    params = list(proj.parameters())
    grads = torch.autograd.grad(loss, [xp, *params])
    flat = reduce_gradients(grads[1:], mesh)
    names = [n for n, _ in proj.named_parameters()]
    full_grads = {}
    for n, g in zip(names, flat):
        dim = split_dim(n) if mesh.tensor_parallel else None
        full_grads[n] = C.gather_shard(g, dim, mesh) if dim is not None else g
    out.update(proj_out=e.detach(), proj_grad_x=grads[0], proj_grads=full_grads, rows=(rows.start, rows.stop))
    return out
