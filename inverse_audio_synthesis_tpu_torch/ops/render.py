"""Fused forward render of the Voice's audio-rate half: a CUDA kernel and its plain version.

``render_audio_fused(routed, scalars, noise, sample_rate)`` maps routed controls
[B, 5, Tc], per-voice scalars [B, 16] and the noise buffer [B, Ta] to audio
[B, Ta], as the JAX package's ``ops/pallas/render.py:render_audio_fused`` does.

- For CUDA tensors it launches the hand-written kernel in ``csrc/render_fwd.cu``
  (built with nvcc for sm_90a at first use, loaded with ctypes), which replaces
  the TPU kernel ``ops/pallas/render.py:_kernel``. It never falls back.
- For CPU tensors it runs ``render_audio_plain``: the same arithmetic in plain
  torch, in the kernel's association (sequential sums within a segment, the
  kernel's warp-shaped scan within a tile, the carry across tiles).

What bounds the kernel on an H100, and what its design does about it, is written
at the top of the CUDA source; PERF.md has its times beside its bound.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

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

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "render_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "--fmad=false", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Launches of the CUDA kernel pair, counted by the wrapper where it launches.
launch_counts = {"render_fwd": 0}

_lib: Optional[ctypes.CDLL] = None
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


def build_render_library() -> Path:
    """Compile ``csrc/render_fwd.cu`` with nvcc into a shared library under
    ``build/kernels`` (named by a hash of the source and flags, so an edit
    rebuilds) and return its path. nvcc's output (ptxas register and
    shared-memory report) is kept beside it as ``<name>.log``."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"render_fwd-{digest}.so"
    if out.exists():
        return out
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the render kernel is built on a machine with the CUDA toolkit")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True, check=False,
        )
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_render_library()))
            fn = lib.render_fwd_launch
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
                ctypes.c_float, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            lib.render_fwd_seg_tile.argtypes = []
            lib.render_fwd_seg_tile.restype = ctypes.c_int
            if lib.render_fwd_seg_tile() != SEG_TILE:
                raise RuntimeError("csrc/render_fwd.cu SEG_TILE differs from ops/render.py")
            _lib = lib
        return _lib


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected float32 {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.requires_grad:
        raise ValueError(
            f"{name} requires grad: the CUDA render has no backward kernel yet "
            "(the pretraining step takes no gradient through the synth)"
        )


def _render_cuda(routed, scalars, noise, sample_rate: float) -> torch.Tensor:
    b, _, tc = routed.shape
    ta = noise.shape[-1]
    device = routed.device
    _check("routed", routed, (b, 5, tc), device)
    _check("scalars", scalars, (b, 16), device)
    _check("noise", noise, (b, ta), device)
    n_tiles = -(-tc // SEG_TILE)
    out = torch.empty((b, ta), dtype=torch.float32, device=device)
    seg_mean = torch.empty((b, 2, n_tiles * SEG_TILE), dtype=torch.float32, device=device)
    seg_offset = torch.empty_like(seg_mean)
    tile_total = torch.empty((b, 2, n_tiles), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.render_fwd_launch(
            routed.data_ptr(), scalars.data_ptr(), noise.data_ptr(), out.data_ptr(),
            seg_mean.data_ptr(), seg_offset.data_ptr(), tile_total.data_ptr(),
            b, tc, ta // tc, dphi_scale(sample_rate), stream,
        )
    if err != 0:
        raise RuntimeError(f"render_fwd_launch failed with CUDA error {err}")
    launch_counts["render_fwd"] += 1
    return out


def render_audio_fused(
    routed: torch.Tensor,  # [B, 5, Tc]
    scalars: torch.Tensor,  # [B, 16]
    noise: torch.Tensor,  # [B, Ta]
    sample_rate: float,
) -> torch.Tensor:
    """Audio-rate render -> [B, Ta]: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    b, five, tc = routed.shape
    ta = noise.shape[-1]
    if five != 5 or not fused_render_supported(b, ta, tc):
        raise ValueError(f"unsupported render geometry routed={tuple(routed.shape)} Ta={ta}")
    if routed.is_cuda:
        return _render_cuda(routed, scalars, noise, sample_rate)
    if routed.device.type != "cpu":
        raise ValueError(f"render_audio_fused runs on CUDA or the CPU, not {routed.device}")
    return render_audio_plain(routed, scalars, noise, sample_rate)


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
    routed: torch.Tensor, scalars: torch.Tensor, noise: torch.Tensor, sample_rate: float
) -> torch.Tensor:
    """The kernel's function in plain torch, in the kernel's order of operations.

    Sums run sequentially over the samples of a segment (a Python loop over the
    ratio), so this is slow on any device; it exists to be compared with."""
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
        offset = fmod_floor(fmod_floor(excl, TWO_PI) + carry[..., None], TWO_PI)
        return within + offset.reshape(b, tcp)[..., None]

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
    return mix.reshape(b, tcp * r)[:, :ta]
