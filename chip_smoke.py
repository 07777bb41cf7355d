#!/usr/bin/env python3
"""Smoke run of the PyTorch port (inverse_audio_synthesis_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device and build: the card's name and power limit, then the render kernel
     built with nvcc from csrc/render_fwd.cu (sm_90a);
  2. the render kernel against its plain version on the card (4 s voices, batch
     16 and 128, params and noise from the port's own sample_voice_params/noise),
     and the kernel's and plain version's times (CUDA events, median of 25
     launches with the L2 cache flushed before each);
  3. four VICReg training steps of the full default config (vicreg=full,
     precision bf16) through Trainer.fit, then one validation step, with the
     launch counters reset just before and read just after;
  4. one JSON line listing every ported kernel with its launches and times.
The last line is {"ok": true, "device": {...}}. Any failure exits non-zero and
prints no result. The script needs a CUDA device and the repository beside it.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 (non-tensor) FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# float32 operations per audio sample in one evaluation of the render
# (csrc/render_fwd.cu:render_audio_kernel): interpolation offset 4, five upsampled
# controls 16, per oscillator 32 (pitch 6, exp2 18, increment 2, phase 6) x 2,
# two sincos reductions 27 x 2, tanh 27, square/saw morph 6, VCAs and mix 11
RENDER_FLOPS_PER_SAMPLE = 182
PHASE_TOLERANCE = {"max_abs": 2e-3, "rel_rms": 1e-4}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int = 25, warmup: int = 3, flush_bytes: int = 256 << 20):
    """Median device time of ``fn()`` in ms: CUDA events around each call, with a
    buffer larger than the 50 MB L2 rewritten before each, as a training step
    leaves the cache between two renders."""
    import torch

    scratch = torch.empty(flush_bytes // 4, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        scratch.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def render_inputs(batch: int, batch_num: int):
    import torch

    from inverse_audio_synthesis_tpu_torch.synth import SynthConfig
    from inverse_audio_synthesis_tpu_torch.synth.voice import (
        compute_controls,
        fused_scalars,
        make_noise,
        sample_voice_params,
    )

    cfg = SynthConfig(batch_size=batch, buffer_size_seconds=4.0)
    params01 = sample_voice_params(batch_num, cfg, "cuda")
    p, routed, midi_f0 = compute_controls(params01, cfg)
    scalars = fused_scalars(p, midi_f0)
    noise = make_noise(cfg, "cuda")
    torch.cuda.synchronize()
    return cfg, params01, routed.contiguous(), scalars.contiguous(), noise


def render_bound_ms(routed, noise) -> tuple[float, str]:
    """Least time for the render's work on an H100: each input read once and the
    output written once, against the float32 operations it does."""
    b, _, tc = routed.shape
    ta = noise.shape[-1]
    nbytes = 4 * (b * ta + b * 5 * tc + b * 16 + b * ta)
    flops = RENDER_FLOPS_PER_SAMPLE * b * ta
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_render() -> dict:
    import torch

    from inverse_audio_synthesis_tpu_torch.ops import render as R
    from inverse_audio_synthesis_tpu_torch.synth.voice import render_voice

    result = {}
    for batch in (16, 128):
        cfg, params01, routed, scalars, noise = render_inputs(batch, batch_num=1234)
        sr = float(cfg.sample_rate)
        out_k = R.render_audio_fused(routed, scalars, noise, sr)
        out_p = R.render_audio_plain(routed, scalars, noise, sr)
        torch.cuda.synchronize()
        if tuple(out_k.shape) != (batch, cfg.buffer_size) or not torch.isfinite(out_k).all():
            raise AssertionError(f"kernel output not finite or of shape {tuple(out_k.shape)}")
        err = (out_k - out_p).abs()
        max_abs = float(err.max())
        rel_rms = float(err.pow(2).mean().sqrt() / out_p.pow(2).mean().sqrt())
        log(f"[render] B={batch} kernel vs plain: max|d|={max_abs:.3e} rel-rms={rel_rms:.3e}")
        if max_abs > PHASE_TOLERANCE["max_abs"] or rel_rms > PHASE_TOLERANCE["rel_rms"]:
            raise AssertionError(f"render kernel disagrees with its plain version: {max_abs}, {rel_rms}")
        # the portable render (render_voice) within the JAX package's render bound
        ref = render_voice(params01, cfg, noise)
        pe = (out_k - ref).abs()
        pe_rms = float(pe.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())
        log(f"[render] B={batch} kernel vs render_voice: max|d|={float(pe.max()):.3e} rel-rms={pe_rms:.3e}")
        if float(pe.max()) > 0.08 or pe_rms > 0.01:
            raise AssertionError("render kernel disagrees with render_voice beyond 0.08 / 0.01")
        ms = cuda_time_ms(lambda: R.render_audio_fused(routed, scalars, noise, sr))
        plain_ms = cuda_time_ms(lambda: R.render_audio_plain(routed, scalars, noise, sr), reps=20)
        bound_ms, bound_by = render_bound_ms(routed, noise)
        log(f"[render] B={batch} kernel {ms:.4f} ms  plain {plain_ms:.3f} ms  "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        result[batch] = dict(max_abs_err=max_abs, rel_rms=rel_rms, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        del out_k, out_p, ref, noise, routed, scalars
        torch.cuda.empty_cache()
    return result


class ListLogger:
    def __init__(self):
        self.records = []

    def log(self, metrics, step=None):
        self.records.append({"step": step, **metrics})


def phase_train(n_steps: int = 4) -> dict:
    import torch

    from inverse_audio_synthesis_tpu_torch.ops import render as R
    from inverse_audio_synthesis_tpu_torch.train.loop import Trainer
    from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask
    from inverse_audio_synthesis_tpu_torch.train.runsetup import BatchNumberSplit
    from inverse_audio_synthesis_tpu_torch.utils.config import load_config

    cfg = load_config(overrides=[f"vicreg.limit_train_batches={n_steps}", "log_every=1"])
    t0 = time.time()
    task = VicregPretrainTask(cfg)
    state = task.init_state()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.model.parameters())
    log(f"[train] vicreg=full dim={cfg.dim} embeddim={cfg.embeddim} projector {cfg.vicreg.mlp} "
        f"batch {cfg.vicreg.batch_size} image {cfg.image.height}x{cfg.image.width} "
        f"precision {cfg.precision}: {n_params} params, set-up {time.time() - t0:.1f} s")
    if not task.fused_render:
        raise AssertionError("the full config's geometry must take the render kernel")
    split = BatchNumberSplit(cfg.num_batches, cfg.ntest_batches, cfg.seed)
    logger = ListLogger()
    trainer = Trainer(task, split, logger=logger, limit_train_batches=n_steps, log_every=1)

    R.reset_launch_counts()
    state = trainer.fit(state)
    val = task.val_step(state, split.val_batch_num(0))
    val = {k: float(v) for k, v in val.items()}
    torch.cuda.synchronize()
    launches = dict(R.launch_counts)

    steps = [r for r in logger.records if "vicreg/train/loss" in r]
    for r in steps:
        log(f"[train] step {r['step']}: loss {r['vicreg/train/loss']:.4f} "
            f"(repr {r['vicreg/train/repr_loss']:.4f} std {r['vicreg/train/std_loss']:.4f} "
            f"cov {r['vicreg/train/cov_loss']:.4f}) lr {r['lr']:.3e} "
            f"step {1e3 / r['steps_per_sec']:.1f} ms notfinite {r['notfinite_steps']:.0f}")
    log(f"[train] validation: " + " ".join(f"{k}={v:.4f}" for k, v in val.items()))
    if len(steps) != n_steps:
        raise AssertionError(f"expected {n_steps} logged steps, got {len(steps)}")
    if not all(math.isfinite(r["vicreg/train/loss"]) for r in steps):
        raise AssertionError("non-finite training loss")
    if any(r["notfinite_steps"] != 0 for r in steps):
        raise AssertionError("non-finite updates were rejected")
    if not all(math.isfinite(v) for v in val.values()):
        raise AssertionError("non-finite validation metrics")
    if launches["render_fwd"] < n_steps + 1:
        raise AssertionError(f"render kernel launched {launches['render_fwd']} times in "
                             f"{n_steps} train steps and one val step")
    step_ms = statistics.median(1e3 / r["steps_per_sec"] for r in steps[1:])
    log(f"[train] median step after the first: {step_ms:.1f} ms; render launches {launches}")
    return {"launches": launches, "step_ms": step_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from inverse_audio_synthesis_tpu_torch.ops import render as R

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}; torch {torch.__version__} CUDA {torch.version.cuda}")
    t0 = time.time()
    lib = R.build_render_library()
    log(f"[build] {lib.name} in {time.time() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    render = phase_render()
    train = phase_train()

    b16 = render[16]
    kernels = [{
        "name": "render_fwd",
        "route": "cuda",
        "source": "inverse_audio_synthesis_tpu_torch/csrc/render_fwd.cu",
        "replaces": "inverse_audio_synthesis_tpu/ops/pallas/render.py:137",
        "launches": train["launches"]["render_fwd"],
        "max_abs_err": b16["max_abs_err"],
        "ms": b16["ms"],
        "plain_ms": b16["plain_ms"],
        "bound_ms": b16["bound_ms"],
        "bound_by": b16["bound_by"],
        "library_ms": None,
        "b128": {k: render[128][k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")},
        "train_step_ms": train["step_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
