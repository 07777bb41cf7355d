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
  Both are built with nvcc for sm_90a at first use and loaded with ctypes. Neither
  falls back.
- For CPU tensors they run ``render_audio_plain`` and ``render_audio_bwd_plain``:
  the same arithmetic in plain torch, in the kernels' association (sequential sums
  within a segment, the kernels' warp-shaped scans and trees within a tile, the
  carries across tiles).

What bounds each kernel on an H100, and what its design does about it, is written
at the top of its CUDA source; PERF.md has their times beside their bounds.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from inverse_audio_synthesis_tpu_torch.ops.math_ops import (
    exp2_accurate,
    sincos_fast,
    tanh_fast,
)
from inverse_audio_synthesis_tpu_torch.ops.scan_ops import TWO_PI, fmod_floor

SEG_TILE = 64  # segments per tile; one thread per segment in the kernel
_WARP = 32
_LN2 = math.log(2.0)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"render_fwd": CSRC / "render_fwd.cu", "render_bwd": CSRC / "render_bwd.cu"}
HEADERS = (CSRC / "render_common.cuh",)
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "--fmad=false", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_PTR, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of each library's launch function (pointers, then batch, tc, ratio,
# the float 2pi/sr, and the stream)
_LAUNCH_ARGS = {
    "render_fwd": [_PTR] * 8 + [_INT] * 3 + [_F32, _PTR],
    "render_bwd": [_PTR] * 11 + [_INT] * 3 + [_F32, _PTR],
}

# Launches of each CUDA kernel group, counted by the wrapper where it launches.
launch_counts = {"render_fwd": 0, "render_bwd": 0}

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def fused_render_supported(batch: int, audio_len: int, control_len: int) -> bool:
    """The kernel takes an integer audio/control ratio in [2, 128] (the JAX
    kernel's gate; 128 also bounds the kernel's shared-memory tile)."""
    if control_len <= 0 or audio_len % control_len != 0:
        return False
    return 2 <= audio_len // control_len <= 128


def dphi_scale(sample_rate: float) -> float:
    """2pi/sr computed in double and rounded once to float32, as the JAX package's
    ``(2.0 * jnp.pi / sample_rate) * freq`` rounds it."""
    return float(np.float32(2.0 * math.pi / float(sample_rate)))


# -- build and bind -----------------------------------------------------------------


def _library_path(name: str) -> Path:
    """build/kernels/<name>-<hash>.so, the hash over the source, the shared header
    and the flags, so an edit rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name], *HEADERS):
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc(nvcc: str, name: str, out: Path) -> None:
    """Build ``csrc/<name>.cu`` into ``out`` (written under a temporary name, then
    renamed), keeping nvcc's output beside it as ``<out>.log``."""
    tmp = out.with_name(f"{out.name}.tmp-{os.getpid()}")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(SOURCES[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc {SOURCES[name].name} failed ({proc.returncode}):\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)


def build_render_libraries(names=tuple(SOURCES)) -> Dict[str, Path]:
    """Compile each named ``csrc/<name>.cu`` with nvcc into a shared library under
    ``build/kernels``, one nvcc process per source, all started together, and
    return their paths. A library already built from the same sources is reused.
    nvcc's output (ptxas register and shared-memory report) is kept beside each
    as ``<name>.log``."""
    out = {name: _library_path(name) for name in names}
    todo = [name for name in names if not out[name].exists()]
    if not todo:
        return out
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the render kernels are built on a machine with the CUDA toolkit")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(todo)) as pool:
        for job in [pool.submit(_nvcc, nvcc, name, out[name]) for name in todo]:
            job.result()
    return out


def _library(name: str) -> ctypes.CDLL:
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build_render_libraries((name,))[name]))
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = _LAUNCH_ARGS[name]
            fn.restype = ctypes.c_int
            tile = getattr(lib, f"{name}_seg_tile")
            tile.argtypes = []
            tile.restype = ctypes.c_int
            if tile() != SEG_TILE:
                raise RuntimeError(f"csrc/{name}.cu SEG_TILE differs from ops/render.py")
            _libs[name] = lib
        return _libs[name]


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
    launch_counts[name] += 1


def _render_cuda(routed, scalars, noise, sample_rate: float, save_phase: bool):
    b, _, tc = routed.shape
    ta = noise.shape[-1]
    device = routed.device
    _check("routed", routed, (b, 5, tc), device)
    _check("scalars", scalars, (b, 16), device)
    _check("noise", noise, (b, ta), device)
    tcp = -(-tc // SEG_TILE) * SEG_TILE
    out = torch.empty((b, ta), dtype=torch.float32, device=device)
    seg_mean = torch.empty((b, 2, tcp), dtype=torch.float32, device=device)
    seg_offset = torch.empty_like(seg_mean)
    tile_total = torch.empty((b, 2, tcp // SEG_TILE), dtype=torch.float32, device=device)
    phase_offset = torch.empty_like(seg_mean) if save_phase else None
    _launch(
        "render_fwd", routed, scalars, noise, out, seg_mean, seg_offset, tile_total,
        phase_offset if save_phase else None, b, tc, ta // tc, dphi_scale(sample_rate),
    )
    return (out, seg_mean, phase_offset) if save_phase else out


def _render_bwd_cuda(routed, scalars, noise, g, seg_mean, phase_offset, sample_rate: float):
    b, _, tc = routed.shape
    ta = noise.shape[-1]
    device = routed.device
    tcp = -(-tc // SEG_TILE) * SEG_TILE
    n_tiles = tcp // SEG_TILE
    _check("routed", routed, (b, 5, tc), device)
    _check("scalars", scalars, (b, 16), device)
    _check("noise", noise, (b, ta), device)
    _check("g", g, (b, ta), device)
    _check("seg_mean", seg_mean, (b, 2, tcp), device)
    _check("phase_offset", phase_offset, (b, 2, tcp), device)
    f32 = dict(dtype=torch.float32, device=device)
    seg_suffix = torch.empty((b, 2, tcp), **f32)
    tile_total = torch.empty((b, 2, n_tiles), **f32)
    d_seg = torch.empty((b, 5, 3, tcp), **f32)
    d_part = torch.empty((b, n_tiles, 16), **f32)
    d_scalars = torch.empty((b, 16), **f32)
    _launch(
        "render_bwd", routed, scalars, noise, g, seg_mean, phase_offset, seg_suffix,
        tile_total, d_seg, d_part, d_scalars, b, tc, ta // tc, dphi_scale(sample_rate),
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


def _tile_inclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan over the last axis (SEG_TILE) with the kernel's association:
    a Hillis-Steele scan within each warp of 32, then the warp totals added in
    order (render_fwd.cu:block_inclusive_scan)."""
    lead = x.shape[:-1]
    v = x.reshape(*lead, SEG_TILE // _WARP, _WARP)
    off = 1
    while off < _WARP:
        v = torch.cat([v[..., :off], v[..., off:] + v[..., :-off]], dim=-1)
        off *= 2
    warps = list(v.unbind(-2))
    prefix = torch.zeros_like(warps[0][..., -1])
    for w in range(1, len(warps)):
        prefix = prefix + warps[w - 1][..., -1]
        warps[w] = prefix[..., None] + warps[w]
    return torch.stack(warps, dim=-2).reshape(x.shape)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device. On CUDA, torch turns division by
    a Python scalar into multiplication by its rounded reciprocal, which the
    kernel's IEEE division does not do; a 0-dim tensor on x's device keeps it a
    true division."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def render_audio_plain(
    routed: torch.Tensor, scalars: torch.Tensor, noise: torch.Tensor, sample_rate: float,
    save_phase: bool = False,
):
    """The kernel's function in plain torch, in the kernel's order of operations.

    Sums run sequentially over the samples of a segment (a Python loop over the
    ratio), so this is slow on any device; it exists to be compared with. With
    ``save_phase`` it also returns the segment means and final phase offsets
    ([B, 2, tcp] each), as the kernel writes them for the backward."""
    routed = routed.float()
    scalars = scalars.float()
    b, _, tc = routed.shape
    ta = noise.shape[-1]
    r = ta // tc
    n_tiles = -(-tc // SEG_TILE)
    tcp = n_tiles * SEG_TILE
    device = routed.device
    seg = torch.arange(tcp, device=device)
    left = routed[..., seg.clamp(max=tc - 1)]  # [B, 5, tcp]
    prev = routed[..., (seg - 1).clamp(0, tc - 1)]
    nxt = routed[..., (seg + 1).clamp(max=tc - 1)]
    jw = _div(torch.arange(r, dtype=torch.float32, device=device) + 0.5, float(r)) - 0.5
    w = torch.abs(jw)
    use_prev = jw < 0.0

    def up(sig: int) -> torch.Tensor:  # [B, tcp, r]
        neighbor = torch.where(use_prev, prev[:, sig, :, None], nxt[:, sig, :, None])
        return left[:, sig, :, None] * (1.0 - w) + neighbor * w

    def col(i: int) -> torch.Tensor:
        return scalars[:, i][:, None, None]

    scale = dphi_scale(sample_rate)
    ramp = torch.arange(1, r + 1, dtype=torch.float32, device=device)

    saved = []

    def phase(sig: int, base: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        midi = torch.clamp(base + depth * up(sig), 0.0, 127.0)
        dphi = scale * (440.0 * exp2_accurate(_div(midi - 69.0, 12.0)))
        total = torch.zeros_like(dphi[..., 0])
        for j in range(r):
            total = total + dphi[..., j]
        mean = _div(total, float(r))
        delta = dphi - mean[..., None]
        acc = torch.empty_like(dphi)
        run = torch.zeros_like(mean)
        for j in range(r):
            run = run + delta[..., j]
            acc[..., j] = run
        within = mean[..., None] * ramp + acc  # [B, tcp, r]
        totals = fmod_floor(within[..., -1], TWO_PI).reshape(b, n_tiles, SEG_TILE)
        incl = _tile_inclusive_scan(totals)
        excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], dim=-1)
        tile_total = fmod_floor(incl[..., -1], TWO_PI)  # [B, n_tiles]
        carries = [torch.zeros_like(tile_total[:, 0])]
        for k in range(n_tiles - 1):
            carries.append(fmod_floor(carries[-1] + tile_total[:, k], TWO_PI))
        carry = torch.stack(carries, dim=1)  # [B, n_tiles]
        offset = fmod_floor(fmod_floor(excl, TWO_PI) + carry[..., None], TWO_PI).reshape(b, tcp)
        saved.append((mean, offset))
        return within + offset[..., None]

    phase1 = phase(0, col(0), col(1)) + col(2)
    _, cos1 = sincos_fast(phase1)
    mix = col(8) * cos1 * torch.clamp_min(up(1), 0.0)
    phase2 = phase(2, col(3), col(4)) + col(5)
    sin2, cos2 = sincos_fast(phase2)
    shape = col(6)
    square = tanh_fast(math.pi * col(7) * sin2 / 2.0)
    osc2 = (1.0 - shape / 2.0) * square * (1.0 + shape * cos2)
    mix = mix + col(9) * osc2 * torch.clamp_min(up(3), 0.0)
    noise3 = torch.nn.functional.pad(noise.float(), (0, tcp * r - ta)).reshape(b, tcp, r)
    mix = mix + col(10) * noise3 * torch.clamp_min(up(4), 0.0)
    audio = mix.reshape(b, tcp * r)[:, :ta]
    if not save_phase:
        return audio
    seg_mean = torch.stack([m for m, _ in saved], dim=1)
    phase_offset = torch.stack([o for _, o in saved], dim=1)
    return audio, seg_mean, phase_offset


# -- the backward's plain version ----------------------------------------------------


def _tile_inclusive_suffix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix scan over the last axis (SEG_TILE) with the kernel's
    association (render_bwd.cu:block_inclusive_suffix): the forward scan's
    association, mirrored."""
    return _tile_inclusive_scan(x.flip(-1)).flip(-1)


def _tile_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (SEG_TILE) as the kernel reduces a tile: a shuffle
    tree inside each warp of 32, then the warp totals in order."""
    v = x.reshape(*x.shape[:-1], SEG_TILE // _WARP, _WARP)
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
    (csrc/render_bwd.cu): per segment a walk forward in time (phase recompute from
    the saved means and offsets, oscillator, VCA and mixer cotangents), the suffix
    sums of d(phase) within the tile and across later tiles, then a walk backward
    in time (the pitch chain, masked strictly: 0 < pre < 127, u > 0). Returns
    (d_routed [B, 5, Tc], d_scalars [B, 16]). A Python loop over the ratio, twice:
    slow on any device; it exists to be compared with."""
    routed, scalars = routed.float(), scalars.float()
    b, _, tc = routed.shape
    ta = noise.shape[-1]
    r = ta // tc
    n_tiles = -(-tc // SEG_TILE)
    tcp = n_tiles * SEG_TILE
    device = routed.device
    seg = torch.arange(tcp, device=device)
    valid = seg < tc
    left = routed[..., seg.clamp(max=tc - 1)]  # [B, 5, tcp]
    prev = routed[..., (seg - 1).clamp(0, tc - 1)]
    nxt = routed[..., (seg + 1).clamp(max=tc - 1)]
    # interpolation offsets as the kernel computes them in float32
    jw = (np.arange(r, dtype=np.float32) + np.float32(0.5)) / np.float32(r) - np.float32(0.5)
    jw_t = torch.from_numpy(jw).to(device)
    w_t = torch.abs(jw_t)
    zero = torch.zeros((), dtype=torch.float32, device=device)

    def weights(j: int):  # (w, use_prev, w_left, w_prev, w_next)
        w, use_prev = w_t[j], bool(jw[j] < 0.0)
        return w, use_prev, 1.0 - w, (w if use_prev else zero), (zero if use_prev else w)

    def up(sig: int, w, use_prev: bool) -> torch.Tensor:  # [B, tcp]
        neighbor = prev[:, sig] if use_prev else nxt[:, sig]
        return left[:, sig] * (1.0 - w) + neighbor * w

    def col(i: int) -> torch.Tensor:
        return scalars[:, i][:, None]

    scale = dphi_scale(sample_rate)

    def increment(u, base, depth):
        pre = base + depth * u
        midi = torch.minimum(torch.maximum(pre, zero), zero + 127.0)
        return pre, scale * (440.0 * exp2_accurate(_div(midi - 69.0, 12.0)))

    pad = tcp * r - ta
    g3 = torch.nn.functional.pad(g.float(), (0, pad)).reshape(b, tcp, r)
    n3 = torch.nn.functional.pad(noise.float(), (0, pad)).reshape(b, tcp, r)
    mean, offset = seg_mean.float(), phase_offset.float()

    def masked(x):  # padded segments contribute exactly zero
        return torch.where(valid, x, zero)

    def mask_of(cond: torch.Tensor) -> torch.Tensor:
        return cond.to(torch.float32)

    # forward in time
    acc = [torch.zeros((b, tcp), device=device) for _ in range(2)]
    ds = {i: torch.zeros((b, tcp), device=device) for i in range(11)}
    dw = {s: [torch.zeros((b, tcp), device=device) for _ in range(3)] for s in range(5)}
    d_phase = torch.empty((b, 2, tcp, r), dtype=torch.float32, device=device)
    for j in range(r):
        w, use_prev, wl, wp, wn = weights(j)
        ramp = float(j + 1)
        phase = []
        for o in range(2):
            _, d = increment(up(2 * o, w, use_prev), col(3 * o), col(3 * o + 1))
            acc[o] = acc[o] + (d - mean[:, o])
            phase.append((mean[:, o] * ramp + acc[o]) + offset[:, o])
        gj, nz = g3[..., j], n3[..., j]
        s1, c1 = sincos_fast(phase[0] + col(2))
        u1 = up(1, w, use_prev)
        a1 = torch.maximum(u1, zero)
        gl1 = gj * col(8)
        dl1 = (gj * c1) * a1
        du1 = (gl1 * c1) * mask_of(u1 > 0.0)
        dp1 = -(gl1 * a1) * s1
        s2, c2 = sincos_fast(phase[1] + col(5))
        shape, partials = col(6), col(7)
        sq = tanh_fast(math.pi * partials * s2 / 2.0)
        amod = 1.0 - shape / 2.0
        bmod = 1.0 + shape * c2
        osc2 = amod * sq * bmod
        u3 = up(3, w, use_prev)
        a2 = torch.maximum(u3, zero)
        gl2 = gj * col(9)
        dl2 = (gj * osc2) * a2
        dosc2 = gl2 * a2
        du3 = (gl2 * osc2) * mask_of(u3 > 0.0)
        dsq = dosc2 * amod * bmod
        dcos2 = dosc2 * amod * sq * shape
        dshape = dosc2 * (amod * sq * c2 - 0.5 * sq * bmod)
        darg = dsq * (1.0 - sq * sq)
        dpartials = darg * (math.pi * s2 / 2.0)
        dsin2 = darg * (math.pi * partials / 2.0)
        dp2 = dsin2 * c2 - dcos2 * s2
        u4 = up(4, w, use_prev)
        dl3 = (gj * nz) * torch.maximum(u4, zero)
        du4 = (gj * col(10) * nz) * mask_of(u4 > 0.0)
        for i, v in ((2, dp1), (5, dp2), (6, dshape), (7, dpartials), (8, dl1), (9, dl2), (10, dl3)):
            ds[i] = ds[i] + v
        for s, du in ((1, du1), (3, du3), (4, du4)):
            dw[s][0] = dw[s][0] + du * wp
            dw[s][1] = dw[s][1] + du * wl
            dw[s][2] = dw[s][2] + du * wn
        d_phase[:, 0, :, j] = dp1
        d_phase[:, 1, :, j] = dp2

    # per segment the d(phase) total (time order), the later segments of its tile
    # (suffix scan) and the later tiles (from the last one back)
    tot = torch.zeros((b, 2, tcp), device=device)
    for j in range(r):
        tot = tot + d_phase[..., j]
    incl = _tile_inclusive_suffix(masked(tot).reshape(b, 2, n_tiles, SEG_TILE))
    excl = torch.cat([incl[..., 1:], torch.zeros_like(incl[..., :1])], dim=-1)
    tile_total = incl[..., 0]  # [B, 2, n_tiles]
    later = [torch.zeros_like(tile_total[..., 0])]
    for k in range(n_tiles - 1, 0, -1):
        later.append(later[-1] + tile_total[..., k])
    later = torch.stack(later[::-1], dim=-1)  # [B, 2, n_tiles]: tiles after k
    carry = (excl + later[..., None]).reshape(b, 2, tcp)

    # backward in time
    suf = [torch.zeros((b, tcp), device=device) for _ in range(2)]
    for j in range(r - 1, -1, -1):
        w, use_prev, wl, wp, wn = weights(j)
        for o in range(2):
            base, depth = col(3 * o), col(3 * o + 1)
            u = up(2 * o, w, use_prev)
            suf[o] = suf[o] + d_phase[:, o, :, j]
            d_dphi = suf[o] + carry[:, o]
            pre, dphi = increment(u, base, depth)
            mask = mask_of((pre > 0.0) & (pre < 127.0))
            d_midi = d_dphi * dphi * (_LN2 / 12.0) * mask
            ds[3 * o] = ds[3 * o] + d_midi
            ds[3 * o + 1] = ds[3 * o + 1] + d_midi * u
            du = d_midi * depth
            dw[2 * o][0] = dw[2 * o][0] + du * wp
            dw[2 * o][1] = dw[2 * o][1] + du * wl
            dw[2 * o][2] = dw[2 * o][2] + du * wn

    d_seg = torch.stack([torch.stack([masked(c) for c in dw[s]], dim=1) for s in range(5)], dim=1)
    per_seg = torch.stack([masked(ds[i]) for i in range(11)], dim=-1)  # [B, tcp, 11]
    parts = _tile_tree_sum(per_seg.reshape(b, n_tiles, SEG_TILE, 11).transpose(-1, -2))
    d_scal = torch.zeros((b, 11), device=device)
    for k in range(n_tiles):
        d_scal = d_scal + parts[:, k]
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
