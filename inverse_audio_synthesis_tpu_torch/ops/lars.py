"""One LARS step over a model's parameters in three stages: the CUDA kernels of
``csrc/lars.cu`` and their plain versions.

flash's LARS at zero momentum with the non-finite guard
(``train/optim.py:FusedLars``), cut where the kernels cut it:

1. norm: for each chunk of ``CHUNK`` elements of each tensor, the sums of squares
   of its gradient (rounded to bf16 first where the plan says so: the values of
   ``g.to(torch.bfloat16).float()``) and, for a tensor LARS adapts, of its weight;
2. fold: each tensor's norms from its chunks' sums (summed in float64), the guard
   (every norm finite, and ``agreed`` where a process group voted), each tensor's
   trust ratio ``local_lr`` and decay factor ``wdc``, ``-lr``, and on the card the
   schedule count and non-finite counter advanced;
3. update: ``w + where(ok, -lr * (local_lr * (g + wdc * w)), 0)``, or
   ``w + where(ok, -lr * g, 0)`` for a tensor LARS does not adapt (weight decay 0,
   or excluded from the mask).

``LarsPlan`` holds what stays fixed from step to step: the parameters, each
tensor's chunks and flags and, on the card, their table on the device and the
workspace the three kernels share. ``kernel_step`` makes the three launches of a
step for parameters on a CUDA device (it never falls back: a gradient the kernels
do not take raises); ``norm_partials_plain``, ``fold_plain``, ``factors_plain``
and ``updates_plain`` are the same stages in plain torch, which the card's tests
hold the kernels to. The CPU's step (``train/optim.py:FusedLars.updates``) takes
its norms per tensor from ``torch._foreach_norm`` and the last two stages from
here. Given the same norms, the update is the same bit for bit; the norms' sums
are taken in another order.
"""

from __future__ import annotations

import ctypes
import itertools
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from inverse_audio_synthesis_tpu_torch.ops import build, launches

CHUNK = 16384  # elements a chunk; csrc/lars.cu:CHUNK
MAX_TENSORS = 384  # parameter tensors a launch takes; csrc/lars.cu:MAX_TENSORS
_FLAG_LARS, _FLAG_ROUND = 1, 2  # csrc/lars.cu:FLAG_LARS, FLAG_ROUND
_GRAD_DTYPES = (torch.float32, torch.bfloat16)

launch_counts = launches.counter("lars_norm", "lars_fold", "lars_update")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


class LarsPlan:
    """The fixed part of a LARS step over ``params``: ``lars[i]`` says whether
    tensor i is adapted and decayed (else it takes -lr * g), ``rounds[i]`` whether
    its float32 gradient is rounded to bf16 first. On a CUDA device the parameters
    must be contiguous float32 tensors of that device, and stay where they are:
    their addresses go to the device here, once."""

    def __init__(self, params: Sequence[torch.Tensor], lars: Sequence[bool], rounds: Sequence[bool],
                 weight_decay: float, trust_coefficient: float, eps: float):
        self.params = list(params)
        self.lars = tuple(bool(x) for x in lars)
        self.rounds = tuple(bool(x) for x in rounds)
        if not (len(self.params) == len(self.lars) == len(self.rounds)) or not self.params:
            raise ValueError("one lars and one rounds flag per parameter, and at least one parameter")
        self.weight_decay, self.trust_coefficient, self.eps = float(weight_decay), float(trust_coefficient), float(eps)
        self.device = self.params[0].device
        self.cuda = self.device.type == "cuda"
        counts = [max(1, -(-p.numel() // CHUNK)) for p in self.params]
        starts = [0, *itertools.accumulate(counts)][:-1]
        self.ranges: List[Tuple[int, int]] = [(s, s + c) for s, c in zip(starts, counts)]
        self.n_chunks = sum(counts)
        self.lars_mask = torch.tensor(self.lars, device=self.device)
        if not self.cuda:
            return
        if len(self.params) > MAX_TENSORS:
            raise ValueError(f"the LARS kernels take at most {MAX_TENSORS} parameter tensors, got {len(self.params)}")
        for i, p in enumerate(self.params):
            if p.device != self.device or p.dtype != torch.float32 or not p.is_contiguous():
                raise ValueError(f"parameter {i}: the LARS kernels take contiguous float32 tensors on "
                                 f"{self.device}, got {p.dtype} on {p.device} (contiguous: {p.is_contiguous()})")
        self._ptrs = tuple(p.data_ptr() for p in self.params)
        flags = [(_FLAG_LARS if a else 0) | (_FLAG_ROUND if r else 0) for a, r in zip(self.lars, self.rounds)]
        # csrc/lars.cu:TensorInfo: the weight's address, its size, then the first
        # chunk (low 32 bits) and the flags (high 32 bits)
        self.info = torch.tensor([[p.data_ptr(), p.numel(), s | (f << 32)]
                                  for p, s, f in zip(self.params, starts, flags)],
                                 dtype=torch.int64).to(self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.partials = torch.zeros((self.n_chunks, 2), **f32)  # per chunk: sums of squares of g, w
        self.norms = torch.zeros((len(self.params), 2), **f32)  # per tensor: ||g||, ||w||
        self.factors = torch.zeros((len(self.params), 2), **f32)  # per tensor: local_lr, wdc
        self.step = torch.zeros(2, **f32)  # -lr, and 1 where the step is applied (0: rejected)


# -- the plain version ---------------------------------------------------------------


def gradient_plain(plan: LarsPlan, i: int, g: torch.Tensor) -> torch.Tensor:
    """Gradient ``i`` as the stages read it: float32, rounded to bf16 first where
    the plan says so."""
    return g.to(torch.bfloat16).float() if plan.rounds[i] else g.float()


def _chunk_sums(x: torch.Tensor, n_chunks: int) -> torch.Tensor:
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, n_chunks * CHUNK - flat.numel()))
    return (flat * flat).view(n_chunks, CHUNK).sum(1)


def norm_partials_plain(plan: LarsPlan, grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stage 1: [chunks, 2] sums of squares of each chunk's gradient and (LARS
    tensors only, else 0) weight."""
    rows = []
    for i, (g, w) in enumerate(zip(grads, plan.params)):
        n = plan.ranges[i][1] - plan.ranges[i][0]
        gs = _chunk_sums(gradient_plain(plan, i, g), n)
        ws = _chunk_sums(w.float(), n) if plan.lars[i] else torch.zeros_like(gs)
        rows.append(torch.stack([gs, ws], 1))
    return torch.cat(rows)


def fold_plain(plan: LarsPlan, partials: torch.Tensor) -> torch.Tensor:
    """Stage 2's sums: [tensors, 2] float32 norms (||g||, ||w||), each tensor's
    chunk sums added in float64."""
    sums = torch.stack([partials[a:b].double().sum(0) for a, b in plan.ranges])
    return sums.sqrt().float()


def factors_plain(plan: LarsPlan, norms: torch.Tensor, lr: torch.Tensor, agreed: Optional[torch.Tensor] = None):
    """Stage 2's rest -> (local_lr [tensors], wdc [tensors], -lr, ok): flash's
    trust ratio and decay factor where both norms are > 0 (else 1 and 0), and the
    guard: every norm finite and, where given, ``agreed``."""
    gn, wn = norms[:, 0], norms[:, 1]
    ok = torch.isfinite(norms).all()
    if agreed is not None:
        ok = ok & agreed
    cond = (wn > 0.0) & (gn > 0.0) & plan.lars_mask
    wd = plan.weight_decay
    local_lr = torch.where(cond, plan.trust_coefficient * wn / (gn + wd * wn + plan.eps), 1.0)
    return local_lr, torch.where(cond, wd, 0.0), -lr, ok


def updates_plain(plan: LarsPlan, grads: Sequence[torch.Tensor], local_lr: torch.Tensor, wdc: torch.Tensor,
                  neglr: torch.Tensor, ok: torch.Tensor) -> List[torch.Tensor]:
    """Stage 3: the update of each parameter (the caller adds it)."""
    out = []
    for i, (g, w) in enumerate(zip(grads, plan.params)):
        g = gradient_plain(plan, i, g)
        upd = neglr * (local_lr[i] * (g + wdc[i] * w.float())) if plan.lars[i] else neglr * g
        out.append(torch.where(ok, upd, 0.0))
    return out


# -- the kernels -------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build.build_libraries(("lars",))["lars"]))
            ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            ptrs, flags = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_ubyte)
            lib.lars_norm_launch.argtypes = [ptrs, flags, i32, ptr, i32, ptr, ptr]
            lib.lars_fold_launch.argtypes = [ptr, ptr, i32, i32, f32, f32, f32] + [ptr] * 8
            lib.lars_update_launch.argtypes = [ptrs, flags, i32, ptr, i32, ptr, ptr, ptr]
            for fn in (lib.lars_norm_launch, lib.lars_fold_launch, lib.lars_update_launch,
                       lib.lars_chunk, lib.lars_max_tensors, lib.lars_occupancy):
                fn.restype = ctypes.c_int
            lib.lars_chunk.argtypes = lib.lars_max_tensors.argtypes = []
            lib.lars_occupancy.argtypes = [i32]
            if lib.lars_chunk() != CHUNK or lib.lars_max_tensors() != MAX_TENSORS:
                raise RuntimeError("csrc/lars.cu's CHUNK or MAX_TENSORS differs from ops/lars.py's")
            _lib = lib
        return _lib


def kernel_occupancy(update: bool) -> int:
    """Resident blocks per SM of the norm pass, or of the update pass (needs the card)."""
    return int(_library().lars_occupancy(int(update)))


def _gradient_args(plan: LarsPlan, grads: Sequence[torch.Tensor]):
    """The host arrays of the gradients' addresses and bf16 flags, after checking
    that the kernels take each gradient and that no parameter moved."""
    if len(grads) != len(plan.params):
        raise ValueError(f"{len(grads)} gradients for {len(plan.params)} parameters")
    for i, (g, p) in enumerate(zip(grads, plan.params)):
        if g.device != plan.device or g.dtype not in _GRAD_DTYPES or g.numel() != p.numel() or not g.is_contiguous():
            raise ValueError(f"gradient {i}: the LARS kernels take contiguous float32 or bfloat16 tensors of "
                             f"{p.numel()} elements on {plan.device}, got {g.dtype} {tuple(g.shape)} on {g.device} "
                             f"(contiguous: {g.is_contiguous()})")
        if p.data_ptr() != plan._ptrs[i]:
            raise RuntimeError(f"parameter {i} moved since the LARS plan was made (rebound with .data =?)")
    n = len(grads)
    return (ctypes.c_void_p * n)(*[g.data_ptr() for g in grads]), \
        (ctypes.c_ubyte * n)(*[g.dtype == torch.bfloat16 for g in grads])


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}_launch failed with CUDA error {err}")
    launches.count(name)


def kernel_step(plan: LarsPlan, grads: Sequence[torch.Tensor], lr: torch.Tensor, count: torch.Tensor,
                total_notfinite: torch.Tensor,
                between: Optional[Callable[[torch.Tensor], Optional[torch.Tensor]]] = None) -> None:
    """One step on the card: the norm pass into ``plan.partials``, then
    ``between(plan.partials)`` where given (the process group's reduction; it
    returns the ranks' agreed finite flag or None), the fold (``lr`` a float32
    scalar on the device; ``count`` and ``total_notfinite`` int32 scalars it
    advances) and the update of the parameters in place. Three launches on the
    current stream; nothing waits for the device."""
    if not plan.cuda:
        raise ValueError("the LARS kernels run on parameters on a CUDA device")
    if lr.device != plan.device or lr.dtype != torch.float32 or lr.numel() != 1:
        raise ValueError(f"lr: expected a float32 scalar on {plan.device}, got {lr.dtype} {tuple(lr.shape)} on {lr.device}")
    for name, t in (("count", count), ("total_notfinite", total_notfinite)):
        if t.device != plan.device or t.dtype != torch.int32 or t.numel() != 1:
            raise ValueError(f"{name}: expected an int32 scalar on {plan.device}")
    lib = _library()
    ptrs, bf16 = _gradient_args(plan, grads)
    n = len(plan.params)
    with torch.cuda.device(plan.device):
        stream = torch.cuda.current_stream(plan.device).cuda_stream
        _launched("lars_norm", lib.lars_norm_launch(
            ptrs, bf16, n, plan.info.data_ptr(), plan.n_chunks, plan.partials.data_ptr(), stream))
        agreed = between(plan.partials) if between is not None else None
        if agreed is not None and (agreed.device != plan.device or agreed.dtype != torch.bool):
            raise ValueError(f"agreed: expected a bool scalar on {plan.device}")
        _launched("lars_fold", lib.lars_fold_launch(
            plan.partials.data_ptr(), plan.info.data_ptr(), n, plan.n_chunks, plan.weight_decay,
            plan.trust_coefficient, plan.eps, lr.data_ptr(), agreed.data_ptr() if agreed is not None else None,
            count.data_ptr(), total_notfinite.data_ptr(), plan.norms.data_ptr(), plan.factors.data_ptr(),
            plan.step.data_ptr(), stream))
        _launched("lars_update", lib.lars_update_launch(
            ptrs, bf16, n, plan.info.data_ptr(), plan.n_chunks, plan.factors.data_ptr(),
            plan.step.data_ptr(), stream))
