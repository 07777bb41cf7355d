"""Fused render of the Voice's audio-rate half and its backward: CUDA kernels and
their plain versions.

``render_audio_fused(routed, scalars, noise, sample_rate)`` maps routed controls
[B, 5, Tc], per-voice scalars [B, 16] and the noise buffer [B, Ta] to audio
[B, Ta], as the JAX package's ``ops/pallas/render.py:render_audio_fused`` does.
When ``routed`` or ``scalars`` needs a gradient it runs inside ``FusedRender``,
a ``torch.autograd.Function`` whose backward returns (d_routed, d_scalars) as the
JAX package's ``render_audio_fused_bwd`` does.

- For CUDA tensors the forward launches the hand-written kernel in
  ``csrc/render_fwd.cu`` (replacing the TPU kernel ``ops/pallas/render.py:_kernel``)
  and the backward the one in ``csrc/render_bwd.cu`` (replacing ``_bwd_kernel``).
  Both are built with nvcc for sm_90a at first use (``ops/build.py``) and loaded
  with ctypes. Neither
  falls back.
- For CPU tensors they run ``render_audio_plain`` and ``render_audio_bwd_plain``:
  the same arithmetic in plain torch, in the kernels' association (each thread's
  run of samples summed in order, the warp-shaped scans and trees over the lanes
  of a segment and over a tile, the chained carries across tiles).

What bounds each kernel on an H100, and what its design does about it, is written
at the top of its CUDA source; PERF.md has their times beside their bounds.
"""

from __future__ import annotations

import ctypes
import math
import re
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from inverse_audio_synthesis_tpu_torch.ops import build, launches
from inverse_audio_synthesis_tpu_torch.ops.math_ops import (
    exp2_accurate,
    sincos_fast,
    tanh_fast,
)
from inverse_audio_synthesis_tpu_torch.ops.scan_ops import TWO_PI, fmod_floor

SEG_TILE = 32  # segments per tile (one block of the kernels)
LANES = 8  # threads per segment; lane k owns samples [k*run, k*run + run)
MAX_RUN = 16  # samples per thread at most: ratio <= LANES * MAX_RUN
_WARP = 32
_LN2 = math.log(2.0)

_PTR, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of each library's launch function (pointers, then batch, tc, ratio,
# the float 2pi/sr, and the stream)
_LAUNCH_ARGS = {
    "render_fwd": [_PTR] * 7 + [_INT] * 3 + [_F32, _PTR],
    "render_bwd": [_PTR] * 10 + [_INT] * 3 + [_F32, _PTR],
}

# Launches of each CUDA kernel, counted by the wrapper where it launches (graph
# captures and replays: ``ops/launches.py``).
launch_counts = launches.counter("render_fwd", "render_bwd")

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def fused_render_supported(batch: int, audio_len: int, control_len: int) -> bool:
    """The kernel takes an integer audio/control ratio in [2, 128] (the JAX
    kernel's gate; 128 = LANES * MAX_RUN also bounds the kernels' runs)."""
    if control_len <= 0 or audio_len % control_len != 0:
        return False
    return 2 <= audio_len // control_len <= 128


def dphi_scale(sample_rate: float) -> float:
    """2pi/sr computed in double and rounded once to float32, as the JAX package's
    ``(2.0 * jnp.pi / sample_rate) * freq`` rounds it."""
    return float(np.float32(2.0 * math.pi / float(sample_rate)))


# -- build and bind -----------------------------------------------------------------


def _library(name: str) -> ctypes.CDLL:
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build.build_libraries((name,))[name]))
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = _LAUNCH_ARGS[name]
            fn.restype = ctypes.c_int
            tile = getattr(lib, f"{name}_seg_tile")
            tile.argtypes = []
            tile.restype = ctypes.c_int
            if tile() != SEG_TILE:
                raise RuntimeError(f"csrc/{name}.cu SEG_TILE differs from ops/render.py")
            getattr(lib, f"{name}_occupancy").restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def ptxas_report(log: str, run: int) -> Dict[str, int]:
    """From nvcc's ``-Xptxas -v`` output (the ``.log`` beside a library): the
    registers, shared memory, stack and spills of the render kernel instantiated
    for runs of ``run`` samples (``render_kernel<run>`` or ``render_bwd_kernel<run>``)."""
    entry, found = None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        if entry is None or f"_kernelILi{run}E" not in entry:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            found.update(stack_bytes=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m:
            found.update(registers=int(m[1]), smem_bytes=int(m[2]))
    return found


def kernel_occupancy(name: str) -> int:
    """Resident blocks per SM of the kernel in ``csrc/<name>.cu``, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor at its registers and shared
    memory (needs the card)."""
    return int(getattr(_library(name), f"{name}_occupancy")())


def sequence_mismatches() -> Tuple[int, int, int, int]:
    """Run the card's exhaustive check of the kernels' division, remainder and
    floor sequences (csrc/render_fwd.cu:check_sequences_kernel) -> the floats of
    each one's domain where it differs from IEEE division, fmodf or floorf: x / 12,
    tanh's (y - 1) / (y + 1), mod 2pi, floor. All are 0 when the kernels compute
    what the plain versions do."""
    fn = _library("render_fwd").render_fwd_check_sequences
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 4)()
    if fn(out) != 0:
        raise RuntimeError("render_fwd_check_sequences failed")
    return tuple(int(v) for v in out)


def _sync_words(n: int, device) -> torch.Tensor:
    """The kernels' ticket counter and status words, all bits set: a fresh chain
    per call (csrc/render_common.cuh)."""
    return torch.full((n,), -1, dtype=torch.int64, device=device)


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected float32 {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name: str, *args) -> None:
    device = args[0].device
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    lib = _library(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"{name}_launch")(*ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{name}_launch failed with CUDA error {err}")
    launches.count(name)


def _render_cuda(routed, scalars, noise, sample_rate: float, save_phase: bool):
    b, _, tc = routed.shape
    ta = noise.shape[-1]
    device = routed.device
    _check("routed", routed, (b, 5, tc), device)
    _check("scalars", scalars, (b, 16), device)
    _check("noise", noise, (b, ta), device)
    n_tiles = -(-tc // SEG_TILE)
    out = torch.empty((b, ta), dtype=torch.float32, device=device)
    seg_mean = phase_offset = None
    if save_phase:
        seg_mean = torch.empty((b, 2, n_tiles * SEG_TILE), dtype=torch.float32, device=device)
        phase_offset = torch.empty_like(seg_mean)
    sync = _sync_words(1 + b * n_tiles, device)
    _launch(
        "render_fwd", routed, scalars, noise, out, seg_mean, phase_offset, sync,
        b, tc, ta // tc, dphi_scale(sample_rate),
    )
    return (out, seg_mean, phase_offset) if save_phase else out


def _render_bwd_cuda(routed, scalars, noise, g, seg_mean, phase_offset, sample_rate: float):
    b, _, tc = routed.shape
    ta = noise.shape[-1]
    device = routed.device
    n_tiles = -(-tc // SEG_TILE)
    tcp = n_tiles * SEG_TILE
    _check("routed", routed, (b, 5, tc), device)
    _check("scalars", scalars, (b, 16), device)
    _check("noise", noise, (b, ta), device)
    _check("g", g, (b, ta), device)
    _check("seg_mean", seg_mean, (b, 2, tcp), device)
    _check("phase_offset", phase_offset, (b, 2, tcp), device)
    f32 = dict(dtype=torch.float32, device=device)
    d_seg = torch.empty((b, 5, 3, tcp), **f32)
    d_part = torch.empty((b, n_tiles, 16), **f32)
    d_scalars = torch.empty((b, 16), **f32)
    sync = _sync_words(1 + b * n_tiles + b, device)
    _launch(
        "render_bwd", routed, scalars, noise, g, seg_mean, phase_offset, d_seg, d_part,
        d_scalars, sync, b, tc, ta // tc, dphi_scale(sample_rate),
    )
    return assemble_d_routed(d_seg, tc), d_scalars


def _check_geometry(routed: torch.Tensor, noise: torch.Tensor) -> None:
    b, five, tc = routed.shape
    ta = noise.shape[-1]
    if five != 5 or not fused_render_supported(b, ta, tc):
        raise ValueError(f"unsupported render geometry routed={tuple(routed.shape)} Ta={ta}")
    if not routed.is_cuda and routed.device.type != "cpu":
        raise ValueError(f"the fused render runs on CUDA or the CPU, not {routed.device}")


def _render_fwd(routed, scalars, noise, sample_rate: float, save_phase: bool):
    _check_geometry(routed, noise)
    if routed.is_cuda:
        return _render_cuda(routed, scalars, noise, sample_rate, save_phase)
    return render_audio_plain(routed, scalars, noise, sample_rate, save_phase=save_phase)


def render_audio_fused_bwd(
    routed: torch.Tensor,  # [B, 5, Tc]
    scalars: torch.Tensor,  # [B, 16]
    noise: torch.Tensor,  # [B, Ta]
    g: torch.Tensor,  # [B, Ta] audio cotangent
    seg_mean: torch.Tensor,  # [B, 2, tcp] saved by the forward
    phase_offset: torch.Tensor,  # [B, 2, tcp] saved by the forward
    sample_rate: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of the render -> (d_routed [B, 5, Tc], d_scalars [B, 16]): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    _check_geometry(routed, noise)
    if routed.is_cuda:
        return _render_bwd_cuda(routed, scalars, noise, g, seg_mean, phase_offset, sample_rate)
    return render_audio_bwd_plain(routed, scalars, noise, g, seg_mean, phase_offset, sample_rate)


class FusedRender(torch.autograd.Function):
    """The render with its hand-written backward: the forward saves each segment's
    mean increment and final phase offset, the backward runs K2 from them. The
    noise is a fixed buffer and gets no gradient."""

    @staticmethod
    def forward(ctx, routed, scalars, noise, sample_rate: float):
        routed, scalars = routed.float().contiguous(), scalars.float().contiguous()
        audio, seg_mean, phase_offset = _render_fwd(
            routed, scalars, noise, sample_rate, save_phase=True
        )
        ctx.save_for_backward(routed, scalars, noise, seg_mean, phase_offset)
        ctx.sample_rate = sample_rate
        return audio

    @staticmethod
    def backward(ctx, g):
        routed, scalars, noise, seg_mean, phase_offset = ctx.saved_tensors
        d_routed, d_scalars = render_audio_fused_bwd(
            routed, scalars, noise, g.float().contiguous(), seg_mean, phase_offset,
            ctx.sample_rate,
        )
        return d_routed, d_scalars, None, None


def render_audio_fused(
    routed: torch.Tensor,  # [B, 5, Tc]
    scalars: torch.Tensor,  # [B, 16]
    noise: torch.Tensor,  # [B, Ta]
    sample_rate: float,
    save_phase: bool = False,
):
    """Audio-rate render -> [B, Ta]: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Differentiable in ``routed`` and ``scalars`` through
    ``FusedRender`` when either needs a gradient. ``save_phase`` (no gradient)
    also returns what the backward reads: the segment means and final phase
    offsets, each [B, 2, tcp]."""
    if not save_phase and torch.is_grad_enabled() and (routed.requires_grad or scalars.requires_grad):
        return FusedRender.apply(routed, scalars, noise, sample_rate)
    return _render_fwd(routed, scalars, noise, sample_rate, save_phase)


# -- the plain version ---------------------------------------------------------------
#
# The kernels' layout (csrc/render_common.cuh): a tile of SEG_TILE segments per
# block, LANES threads per segment, lane k owning the run of samples
# [k*run, k*run + run) of its segment, run = ceil(ratio / LANES). Below, a
# segment's samples are held in that slot layout, [..., LANES, run]: slot (k, i)
# is sample k*run + i, and the slots at or past the ratio hold no sample.


def run_length(ratio: int) -> int:
    """Samples per thread: lane k of a segment owns [k*run, k*run + run)."""
    return -(-ratio // LANES)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device. On CUDA, torch turns division by
    a Python scalar into multiplication by its rounded reciprocal, which the
    kernel's IEEE division does not do; a 0-dim tensor on x's device keeps it a
    true division."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _slots(ratio: int, device):
    """Per slot [LANES, run]: its sample index j, whether it holds a sample, and the
    half-pixel interpolation position jw = (j + 0.5) / ratio - 0.5 as the kernels
    divide it."""
    run = run_length(ratio)
    j = torch.arange(LANES * run, device=device).reshape(LANES, run)
    jw = _div(j.to(torch.float32) + 0.5, float(ratio)) - 0.5
    return j, j < ratio, jw


def _inclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """Hillis-Steele inclusive scan over the last axis, as a warp runs it with
    shuffles: x[k] + x[k - off] for off = 1, 2, 4, ..."""
    off = 1
    while off < x.shape[-1]:
        x = torch.cat([x[..., :off], x[..., off:] + x[..., :-off]], dim=-1)
        off *= 2
    return x


def segment_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a segment's LANES lanes) as the kernels' butterfly
    (render_common.cuh:segment_sum and transpose_sum16): lane pairs 8 apart, then
    4, 2, 1."""
    lane = torch.arange(x.shape[-1], device=x.device)
    m = x.shape[-1] // 2
    while m >= 1:
        x = x + x[..., lane ^ m]
        m //= 2
    return x[..., 0]


def segment_exclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix over the last axis (the lanes): the inclusive warp scan,
    shifted by one lane (render_common.cuh:segment_exclusive_scan)."""
    incl = _inclusive_scan(x)
    return torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], dim=-1)


def segment_exclusive_suffix(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mirror image over the lanes -> (exclusive suffix, the total)."""
    incl = _inclusive_scan(x.flip(-1)).flip(-1)
    return torch.cat([incl[..., 1:], torch.zeros_like(incl[..., :1])], dim=-1), incl[..., 0]


def segment_phase(dphi: torch.Tensor, holds: torch.Tensor, ratio: int):
    """One oscillator's phase inside each segment, in the kernels' association of
    the TPU kernel's mean plus residual prefix.

    ``dphi`` [..., LANES, run] are the increments in slot layout and ``holds``
    [LANES, run] marks the slots that hold a sample. Each lane sums its run in
    order, the butterfly adds the lanes, and the mean is that sum over the ratio.
    The residual prefix at a slot is the exclusive scan of the lanes' residual
    totals plus the lane's own running residual. Returns (mean [...], prefix
    [..., LANES, run], total [...]), the total being mod_2pi(mean * ratio +
    prefix at the segment's last sample)."""
    zero = dphi.new_zeros(())
    run = dphi.shape[-1]
    run_sum = torch.zeros_like(dphi[..., 0])
    for i in range(run):
        run_sum = run_sum + torch.where(holds[:, i], dphi[..., i], zero)
    mean = _div(segment_sum(run_sum), float(ratio))
    res = torch.zeros_like(run_sum)
    own = []
    for i in range(run):
        res = res + torch.where(holds[:, i], dphi[..., i] - mean[..., None], zero)
        own.append(res)
    ex = segment_exclusive_scan(res)
    prefix = torch.stack([ex + p for p in own], dim=-1)
    last = (ratio - 1) // run  # the lane of the segment's last sample
    total = fmod_floor(mean * float(ratio) + (ex[..., last] + res[..., last]), TWO_PI)
    return mean, prefix, total


def _tile_inclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan over the last axis (a tile's <= 32 segments) as the
    kernels' first warp runs it (render_common.cuh:tile_inclusive_scan)."""
    return _inclusive_scan(x)


def chained_tile_carry(tile_total: torch.Tensor) -> torch.Tensor:
    """The phase carried into each tile [..., n_tiles] from the wrapped tile totals,
    chained as the forward kernel chains its blocks: incl[k] = mod_2pi(incl[k-1] +
    total[k]) from incl[-1] = 0, tile k's carry being incl[k-1]."""
    incl = torch.zeros_like(tile_total[..., 0])
    carries = [incl]
    for k in range(tile_total.shape[-1] - 1):
        incl = fmod_floor(incl + tile_total[..., k], TWO_PI)
        carries.append(incl)
    return torch.stack(carries, dim=-1)


def render_audio_plain(
    routed: torch.Tensor, scalars: torch.Tensor, noise: torch.Tensor, sample_rate: float,
    save_phase: bool = False,
):
    """The kernel's function in plain torch, in the kernel's order of operations.

    Loops in Python over a lane's run (at most MAX_RUN) and over the tiles, so it
    is slow on any device; it exists to be compared with. With ``save_phase`` it
    also returns the segment means and final phase offsets ([B, 2, tcp] each), as
    the kernel writes them for the backward."""
    routed = routed.float()
    scalars = scalars.float()
    b, _, tc = routed.shape
    ta = noise.shape[-1]
    r = ta // tc
    run = run_length(r)
    n_tiles = -(-tc // SEG_TILE)
    tcp = n_tiles * SEG_TILE
    device = routed.device
    seg = torch.arange(tcp, device=device)
    left = routed[..., seg.clamp(max=tc - 1)]  # [B, 5, tcp]
    prev = routed[..., (seg - 1).clamp(0, tc - 1)]
    nxt = routed[..., (seg + 1).clamp(max=tc - 1)]
    j, holds, jw = _slots(r, device)  # [LANES, run]
    w = torch.abs(jw)
    use_prev = jw < 0.0

    def up(sig: int) -> torch.Tensor:  # [B, tcp, LANES, run]
        neighbor = torch.where(use_prev, prev[:, sig, :, None, None], nxt[:, sig, :, None, None])
        return left[:, sig, :, None, None] * (1.0 - w) + neighbor * w

    def col(i: int) -> torch.Tensor:
        return scalars[:, i][:, None, None, None]

    scale = dphi_scale(sample_rate)
    ramp = j.to(torch.float32) + 1.0

    saved = []

    def phase(sig: int, base: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        midi = torch.clamp(base + depth * up(sig), 0.0, 127.0)
        dphi = scale * (440.0 * exp2_accurate(_div(midi - 69.0, 12.0)))
        mean, prefix, total = segment_phase(dphi, holds, r)  # [B, tcp], ...
        incl = _tile_inclusive_scan(total.reshape(b, n_tiles, SEG_TILE))
        excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], dim=-1)
        carry = chained_tile_carry(fmod_floor(incl[..., -1], TWO_PI))  # [B, n_tiles]
        offset = fmod_floor(fmod_floor(excl, TWO_PI) + carry[..., None], TWO_PI).reshape(b, tcp)
        saved.append((mean, offset))
        return (mean[..., None, None] * ramp + prefix) + offset[..., None, None]

    phase1 = phase(0, col(0), col(1)) + col(2)
    _, cos1 = sincos_fast(phase1)
    mix = col(8) * cos1 * torch.clamp_min(up(1), 0.0)
    phase2 = phase(2, col(3), col(4)) + col(5)
    sin2, cos2 = sincos_fast(phase2)
    shape = col(6)
    square = tanh_fast(math.pi * col(7) * sin2 / 2.0)
    osc2 = (1.0 - shape / 2.0) * square * (1.0 + shape * cos2)
    mix = mix + col(9) * osc2 * torch.clamp_min(up(3), 0.0)
    mix = mix + col(10) * _slot_layout(noise, tcp, r) * torch.clamp_min(up(4), 0.0)
    audio = mix.reshape(b, tcp, LANES * run)[..., :r].reshape(b, tcp * r)[:, :ta]
    if not save_phase:
        return audio
    seg_mean = torch.stack([m for m, _ in saved], dim=1)
    phase_offset = torch.stack([o for _, o in saved], dim=1)
    return audio, seg_mean, phase_offset


def _slot_layout(x: torch.Tensor, tcp: int, r: int) -> torch.Tensor:
    """[B, Ta] audio-rate values -> [B, tcp, LANES, run], zeros where no sample."""
    b, ta = x.shape
    x = torch.nn.functional.pad(x.float(), (0, tcp * r - ta)).reshape(b, tcp, r)
    run = run_length(r)
    return torch.nn.functional.pad(x, (0, LANES * run - r)).reshape(b, tcp, LANES, run)


# -- the backward's plain version ----------------------------------------------------


def _tile_inclusive_suffix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix scan over the last axis (a tile's segments) with the kernel's
    association (render_common.cuh:tile_inclusive_suffix): the forward scan's
    association, mirrored."""
    return _tile_inclusive_scan(x.flip(-1)).flip(-1)


def chained_tile_suffix(tile_total: torch.Tensor) -> torch.Tensor:
    """d(phase) of all later tiles [..., n_tiles], chained as the backward kernel
    chains its blocks: incl[k] = incl[k+1] + total[k] from incl[n_tiles] = 0, tile
    k's carry being incl[k+1]."""
    incl = torch.zeros_like(tile_total[..., 0])
    later = [incl]
    for k in range(tile_total.shape[-1] - 1, 0, -1):
        incl = incl + tile_total[..., k]
        later.append(incl)
    return torch.stack(later[::-1], dim=-1)


def _tile_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a tile's threads, a multiple of 32) as the kernel
    reduces a tile: a shuffle tree inside each warp of 32, then the warp totals
    in order."""
    v = x.reshape(*x.shape[:-1], x.shape[-1] // _WARP, _WARP)
    half = _WARP // 2
    while half >= 1:
        v = v[..., :half] + v[..., half : 2 * half]
        half //= 2
    warps = v[..., 0].unbind(-1)
    total = warps[0]
    for w in warps[1:]:
        total = total + w
    return total


def assemble_d_routed(d_seg: torch.Tensor, tc: int) -> torch.Tensor:
    """[B, 5, 3, tcp] per-segment cotangents of (previous, left, next) control ->
    d_routed [B, 5, Tc], with the upsampling's edge clamps: segment k reads
    controls max(k-1, 0), k and min(k+1, Tc-1). Padded segments (k >= Tc) carry
    zeros and are dropped. Deterministic on every device (no scatter)."""
    prev, left, nxt = d_seg[:, :, 0, :tc], d_seg[:, :, 1, :tc], d_seg[:, :, 2, :tc]
    d = left.clone()
    d[..., : tc - 1] += prev[..., 1:]
    d[..., 0] += prev[..., 0]
    d[..., 1:] += nxt[..., : tc - 1]
    d[..., tc - 1] += nxt[..., tc - 1]
    return d


def render_audio_bwd_plain(
    routed: torch.Tensor, scalars: torch.Tensor, noise: torch.Tensor, g: torch.Tensor,
    seg_mean: torch.Tensor, phase_offset: torch.Tensor, sample_rate: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's function in plain torch, in its order of operations
    (csrc/render_bwd.cu), one run position of every lane at a time: the increments
    and the lanes' residual prefixes; a walk forward in time (phase recompute from
    the saved means and offsets, oscillator, VCA and mixer cotangents); the suffix
    sums of d(phase) over the lane's run, the later lanes, the later segments of
    the tile and the later tiles; a walk backward in time (the pitch chain, masked
    strictly: 0 < pre < 127, u > 0). Returns (d_routed [B, 5, Tc], d_scalars
    [B, 16]). Slow on any device; it exists to be compared with."""
    routed, scalars = routed.float(), scalars.float()
    b, _, tc = routed.shape
    ta = noise.shape[-1]
    r = ta // tc
    run = run_length(r)
    n_tiles = -(-tc // SEG_TILE)
    tcp = n_tiles * SEG_TILE
    device = routed.device
    seg = torch.arange(tcp, device=device)
    left = routed[..., seg.clamp(max=tc - 1)]  # [B, 5, tcp]
    prev = routed[..., (seg - 1).clamp(0, tc - 1)]
    nxt = routed[..., (seg + 1).clamp(max=tc - 1)]
    j, holds, jw = _slots(r, device)
    holds = holds & (seg < tc)[:, None, None]  # [tcp, LANES, run]: padded segments have none
    w_all = torch.abs(jw)
    zero = torch.zeros((), dtype=torch.float32, device=device)

    def weights(i: int):  # per lane at run position i: (w, w_left, use_prev, w_prev, w_next)
        w, use_prev = w_all[:, i], jw[:, i] < 0.0
        return w, 1.0 - w, use_prev, torch.where(use_prev, w, zero), torch.where(use_prev, zero, w)

    def up(sig: int, w, wl, use_prev) -> torch.Tensor:  # [B, tcp, LANES]
        neighbor = torch.where(use_prev, prev[:, sig, :, None], nxt[:, sig, :, None])
        return left[:, sig, :, None] * wl + neighbor * w

    def col(i: int) -> torch.Tensor:
        return scalars[:, i][:, None, None]

    scale = dphi_scale(sample_rate)

    def increment(u, base, depth):
        midi = torch.minimum(torch.maximum(base + depth * u, zero), zero + 127.0)
        return scale * (440.0 * exp2_accurate(_div(midi - 69.0, 12.0)))

    g4, n4 = _slot_layout(g, tcp, r), _slot_layout(noise, tcp, r)
    mean, offset = seg_mean.float()[..., None], phase_offset.float()[..., None]  # [B, 2, tcp, 1]

    def lanes():
        return torch.zeros((b, tcp, LANES), device=device)

    # the increments, once per sample, and each lane's exclusive residual prefix
    dphi = [[None] * run for _ in range(2)]
    ex = []
    for o in range(2):
        res = lanes()
        for i in range(run):
            w, wl, use_prev, _, _ = weights(i)
            dphi[o][i] = increment(up(2 * o, w, wl, use_prev), col(3 * o), col(3 * o + 1))
            res = res + torch.where(holds[..., i], dphi[o][i] - mean[:, o], zero)
        ex.append(segment_exclusive_scan(res))

    # forward in time
    ds = {i: lanes() for i in range(11)}
    dw = {s: [lanes() for _ in range(3)] for s in range(5)}
    d_phase = [[None] * run for _ in range(2)]
    res = [lanes(), lanes()]
    for i in range(run):
        w, wl, use_prev, wp, wn = weights(i)
        ok = holds[..., i]
        ramp = j[:, i].to(torch.float32) + 1.0
        phase = []
        for o in range(2):
            res[o] = res[o] + torch.where(ok, dphi[o][i] - mean[:, o], zero)
            phase.append((mean[:, o] * ramp + (ex[o] + res[o])) + offset[:, o])
        gj, nz = g4[..., i], n4[..., i]
        s1, c1 = sincos_fast(phase[0] + col(2))
        u1 = up(1, w, wl, use_prev)
        a1 = torch.maximum(u1, zero)
        gl1 = gj * col(8)
        dl1 = (gj * c1) * a1
        du1 = (gl1 * c1) * (u1 > 0.0).to(torch.float32)
        dp1 = -(gl1 * a1) * s1
        s2, c2 = sincos_fast(phase[1] + col(5))
        shape, partials = col(6), col(7)
        sq = tanh_fast(math.pi * partials * s2 / 2.0)
        amod = 1.0 - shape / 2.0
        bmod = 1.0 + shape * c2
        osc2 = amod * sq * bmod
        u3 = up(3, w, wl, use_prev)
        a2 = torch.maximum(u3, zero)
        gl2 = gj * col(9)
        dl2 = (gj * osc2) * a2
        dosc2 = gl2 * a2
        du3 = (gl2 * osc2) * (u3 > 0.0).to(torch.float32)
        dsq = dosc2 * amod * bmod
        dcos2 = dosc2 * amod * sq * shape
        dshape = dosc2 * (amod * sq * c2 - 0.5 * sq * bmod)
        darg = dsq * (1.0 - sq * sq)
        dpartials = darg * (math.pi * s2 / 2.0)
        dsin2 = darg * (math.pi * partials / 2.0)
        dp2 = dsin2 * c2 - dcos2 * s2
        u4 = up(4, w, wl, use_prev)
        dl3 = (gj * nz) * torch.maximum(u4, zero)
        du4 = (gj * col(10) * nz) * (u4 > 0.0).to(torch.float32)
        for k, v in ((2, dp1), (5, dp2), (6, dshape), (7, dpartials), (8, dl1), (9, dl2), (10, dl3)):
            ds[k] = ds[k] + torch.where(ok, v, zero)
        for s, du in ((1, du1), (3, du3), (4, du4)):
            du = torch.where(ok, du, zero)
            dw[s][0] = dw[s][0] + du * wp
            dw[s][1] = dw[s][1] + du * wl
            dw[s][2] = dw[s][2] + du * wn
        d_phase[0][i] = torch.where(ok, dp1, zero)
        d_phase[1][i] = torch.where(ok, dp2, zero)

    # d(phase) over the lane's run (from its end), then the later lanes of the
    # segment, the later segments of the tile and the later tiles
    carry = []
    for o in range(2):
        q = lanes()
        for i in range(run - 1, -1, -1):
            q = q + d_phase[o][i]
        lane_later, seg_total = segment_exclusive_suffix(q)
        incl = _tile_inclusive_suffix(seg_total.reshape(b, n_tiles, SEG_TILE))
        excl = torch.cat([incl[..., 1:], torch.zeros_like(incl[..., :1])], dim=-1)
        seg_carry = (excl + chained_tile_suffix(incl[..., 0])[..., None]).reshape(b, tcp)
        carry.append(lane_later + seg_carry[..., None])

    # backward in time: d(dphi) = suffix of d(phase), then the pitch chain
    for o in range(2):
        base, depth = col(3 * o), col(3 * o + 1)
        q = lanes()
        for i in range(run - 1, -1, -1):
            w, wl, use_prev, wp, wn = weights(i)
            u = up(2 * o, w, wl, use_prev)
            q = q + d_phase[o][i]
            d_dphi = q + carry[o]
            pre = base + depth * u
            mask = ((pre > 0.0) & (pre < 127.0)).to(torch.float32)
            d_midi = torch.where(holds[..., i], d_dphi * dphi[o][i] * (_LN2 / 12.0) * mask, zero)
            ds[3 * o] = ds[3 * o] + d_midi
            ds[3 * o + 1] = ds[3 * o + 1] + d_midi * u
            du = d_midi * depth
            dw[2 * o][0] = dw[2 * o][0] + du * wp
            dw[2 * o][1] = dw[2 * o][1] + du * wl
            dw[2 * o][2] = dw[2 * o][2] + du * wn

    d_seg = torch.stack(
        [torch.stack([segment_sum(c) for c in dw[s]], dim=1) for s in range(5)], dim=1
    )  # [B, 5, 3, tcp]
    per_lane = torch.stack([ds[i] for i in range(11)], dim=1)  # [B, 11, tcp, LANES]
    parts = _tile_tree_sum(per_lane.reshape(b, 11, n_tiles, SEG_TILE * LANES))  # [B, 11, n_tiles]
    d_scal = torch.zeros((b, 11), device=device)
    for k in range(n_tiles):
        d_scal = d_scal + parts[..., k]
    d_scalars = torch.nn.functional.pad(d_scal, (0, 16 - 11))
    return assemble_d_routed(d_seg, tc), d_scalars


def gradient_ties(routed: torch.Tensor, scalars: torch.Tensor, audio_len: int):
    """Where the backward's strict masks and autograd of the plain forward's
    clamps legitimately differ: samples that sit exactly on a mask's threshold
    (an amplitude control u == 0, a pre-clip pitch of exactly 0 or 127), which
    autograd of ``torch.clamp`` passes and the kernels do not. Returns
    (d_routed mask [B, 5, Tc], d_scalars mask [B, 16]) of the entries such
    samples feed, for leaving them out of a comparison with that oracle."""
    routed, scalars = routed.float(), scalars.float()
    b, _, tc = routed.shape
    r = audio_len // tc
    tcp = -(-tc // SEG_TILE) * SEG_TILE
    device = routed.device
    seg = torch.arange(tcp, device=device)
    idx = {"left": seg.clamp(max=tc - 1), "prev": (seg - 1).clamp(0, tc - 1),
           "next": (seg + 1).clamp(max=tc - 1)}
    jw = _div(torch.arange(r, dtype=torch.float32, device=device) + 0.5, float(r)) - 0.5
    w, use_prev = torch.abs(jw), jw < 0.0
    left, prev, nxt = (routed[..., idx[k], None] for k in ("left", "prev", "next"))
    u = left * (1.0 - w) + torch.where(use_prev, prev, nxt) * w  # [B, 5, tcp, r]
    tie = torch.zeros_like(u, dtype=torch.bool)
    tie[:, [1, 3, 4]] = u[:, [1, 3, 4]] == 0.0
    scal_tie = torch.zeros((b, 16), dtype=torch.bool, device=device)
    for o, sig in enumerate((0, 2)):
        pre = scalars[:, 3 * o, None, None] + scalars[:, 3 * o + 1, None, None] * u[:, sig]
        tie[:, sig] = (pre == 0.0) | (pre == 127.0)
        scal_tie[:, 3 * o : 3 * o + 2] = tie[:, sig].any(-1).any(-1)[:, None]
    tie = tie & (seg < tc)[:, None]
    mask = torch.zeros((b, 5, tc), dtype=torch.float32, device=device)
    feeds = {"left": tie.any(-1), "prev": (tie & use_prev & (w > 0)).any(-1),
             "next": (tie & ~use_prev & (w > 0)).any(-1)}
    for k, hit in feeds.items():
        mask.index_add_(-1, idx[k], hit.float())
    return mask > 0, scal_tie
