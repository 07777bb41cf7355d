#!/usr/bin/env python3
"""Smoke run of the PyTorch port (inverse_audio_synthesis_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device and build: the card's name and power limit, then both render kernels
     built with nvcc from csrc/render_fwd.cu and csrc/render_bwd.cu (sm_90a), one
     nvcc process each, started together; each kernel's registers, shared memory
     and spills (ptxas), resident blocks per SM and instructions per sample slot
     (cuobjdump -sass) at the 4 s voices' ratio; the
     card's exhaustive check that the kernels' division, remainder and floor
     sequences equal IEEE division, fmodf and floorf on their domains;
  2. the forward render kernel (K1) against its plain version on the card (4 s
     voices, batch 16, 128 and 1024, params and noise from the port's own
     sample_voice_params/noise), with its saved phase offsets bit-identical to
     the plain version's and a second launch bit-identical to the first, and the
     times of both beside the bound (CUDA events, median over launches with the
     L2 cache flushed before each);
  3. the render backward kernel (K2) against its plain version at batch 128 and
     1024 (d_routed within 5e-4 and d_scalars within 1e-4 of each signal's and
     column's largest value), against autograd of the plain forward at batch 16
     (the same bounds, exact-tie entries left out: there autograd of a clamp
     passes the gradient and the kernel's strict masks do not), and the times of
     both beside the bound;
  4. four VICReg training steps of the full default config (vicreg=full,
     precision bf16) through Trainer.fit, then one validation step, with the
     launch counters reset just before and read just after; the run writes a
     VICReg checkpoint to a temporary directory;
  5. the downstream slice: that checkpoint restored into a fresh
     VicregPretrainTask, then four AudioToParamsTask train steps of the default
     downstream config with audio_to_params.loss=combined (batch 1024, dim 1024,
     4 s voices, bf16) through Trainer.fit, then one test step, with the counters
     reset just before and read just after;
  6. the retrieval eval at the full default config from that checkpoint: the
     planted-query gate, 3 batches of 1024 candidates (16 queries, sub-chunks of
     128, each rendered by K1) through RetrievalEvaluator.run with the counters
     reset just before and read just after (K1 >= 2 + 8 per batch), monotone and
     finite results, ms per batch and candidates/s; then 2 batches with
     save_state_every=1 and a resume to 3, bit-identical to the uninterrupted run;
  7. HEAR: scene and 50 ms timestamp embeddings of two 2.5-window clips, their
     shapes, spacing, a window against the tower on its raw slice, and
     timestamp embeddings per second;
  8. export: embed_audio, predict_params (a fresh head on the frozen towers) and
     render exported with torch.export, saved, reloaded and run on the card
     against the live functions;
  9. one JSON line listing every ported kernel with its launches and times.
The last line is {"ok": true, "device": {...}}. Any failure exits non-zero and
prints no result. The script needs a CUDA device and the repository beside it.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 (non-tensor) FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# float32 operations per audio sample in one evaluation of the render, each value
# counted once (csrc/render_fwd.cu): interpolation offset 4, five upsampled
# controls 16, per oscillator 32 (pitch 6, exp2 18, increment 2, phase 6) x 2,
# two sincos reductions 27 x 2, tanh 27, square/saw morph 6, VCAs and mix 11
RENDER_FLOPS_PER_SAMPLE = 182
# float32 operations per audio sample of the render's backward, each value counted
# once however often the kernel recomputes it (csrc/render_bwd.cu): the forward
# recompute up to the oscillators and VCAs 171 (the render's 182 less the mix); the
# VCA, oscillator and mixer cotangents 46 (VCO 1 9, VCO 2 30, noise 7); their
# per-segment sums 25 (7 scalar adds, 3 x 3 upsample weights by multiply-add, 3
# weights); per oscillator in the backward walk 16 (suffix 2, mask 3, chain 3,
# scalar sums 3, upsample weights 5) x 2. The walk's controls, pre-clip pitch,
# increments and interpolation weights are the forward recompute's values again.
RENDER_BWD_FLOPS_PER_SAMPLE = 171 + 46 + 25 + 2 * 16
PHASE_TOLERANCE = {"max_abs": 2e-3, "rel_rms": 1e-4}
# K2 against its plain version and against autograd: the JAX package's bounds
# for its backward (tests/test_pallas_render.py), per signal / scalar column
BWD_TOLERANCE = {"d_routed": 5e-4, "d_scalars": 1e-4}
N_STEPS = 4


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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time on an H100: the larger of bytes over the memory rate and
    float32 operations over the float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def render_bound_ms(routed, noise) -> tuple[float, str]:
    """The forward reads noise and the routed controls and scalars once and
    writes the audio once."""
    b, _, tc = routed.shape
    ta = noise.shape[-1]
    nbytes = 4 * (b * ta + b * 5 * tc + b * 16 + b * ta)
    return bound_ms(nbytes, RENDER_FLOPS_PER_SAMPLE * b * ta)


def render_bwd_bound_ms(routed, noise, seg_mean) -> tuple[float, str]:
    """The backward reads noise and g, the controls, the scalars and the saved
    means and offsets once, and writes d_routed and d_scalars once."""
    b, _, tc = routed.shape
    ta = noise.shape[-1]
    nbytes = 4 * (2 * b * ta + 2 * b * 5 * tc + 2 * b * 16 + 2 * seg_mean.numel())
    return bound_ms(nbytes, RENDER_BWD_FLOPS_PER_SAMPLE * b * ta)


def sass_per_slot(lib: Path, run: int) -> dict:
    """Instructions of the render kernel instantiated for runs of ``run`` samples in
    the library's SASS (cuobjdump), per sample slot of a run: all of them, and the
    float32 multiplies, adds and FMAs among them. The count is static: each block's
    one-time prologue and warp 0's carry code are included once."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    for function in sass.split("Function : ")[1:]:
        if f"_kernelILi{run}E" not in function.split("\n", 1)[0]:
            continue
        instruction = r"/\*[0-9a-f]{4,5}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)"
        ops = [m.group(1) for m in re.finditer(instruction, function)]
        fp = sum(op in ("FADD", "FMUL", "FFMA") for op in ops)
        return {"sass_per_slot": round(len(ops) / run, 1), "fp32_per_slot": round(fp / run, 1)}
    raise AssertionError(f"no run-{run} kernel in the SASS of {lib.name}")


def phase_render() -> dict:
    import torch

    from inverse_audio_synthesis_tpu_torch.ops import render as R
    from inverse_audio_synthesis_tpu_torch.synth.voice import render_voice

    result = {}
    for batch in (16, 128, 1024):
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
        # what the backward reads: bit-identical to the plain version's
        saved_k = R.render_audio_fused(routed, scalars, noise, sr, save_phase=True)
        saved_p = R.render_audio_plain(routed, scalars, noise, sr, save_phase=True)
        diffs = [float((a - b).abs().max()) for a, b in zip(saved_k, saved_p)]
        log(f"[render] B={batch} with saved phase, kernel vs plain max|d| "
            f"(audio, means, offsets): {diffs}")
        if any(d != 0.0 for d in diffs):
            raise AssertionError("the render kernel with saved offsets is not bit-identical to its plain version")
        saved_k2 = R.render_audio_fused(routed, scalars, noise, sr, save_phase=True)
        repeat = all(torch.equal(a, b) for a, b in zip(saved_k, saved_k2))
        log(f"[render] B={batch} a second launch is bit-identical: {repeat}")
        if not repeat:
            raise AssertionError("the render kernel does not repeat bit for bit")
        del saved_k, saved_p, saved_k2
        if batch <= 128:  # the portable render within the JAX package's render bound
            ref = render_voice(params01, cfg, noise)
            pe = (out_k - ref).abs()
            pe_rms = float(pe.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())
            log(f"[render] B={batch} kernel vs render_voice: max|d|={float(pe.max()):.3e} rel-rms={pe_rms:.3e}")
            if float(pe.max()) > 0.08 or pe_rms > 0.01:
                raise AssertionError("render kernel disagrees with render_voice beyond 0.08 / 0.01")
            del ref, pe
        del out_k, out_p, err
        ms = cuda_time_ms(lambda: R.render_audio_fused(routed, scalars, noise, sr))
        plain_ms = cuda_time_ms(lambda: R.render_audio_plain(routed, scalars, noise, sr),
                                reps=20 if batch <= 128 else 3, warmup=1)
        b_ms, bound_by = render_bound_ms(routed, noise)
        log(f"[render] B={batch} kernel {ms:.4f} ms  plain {plain_ms:.3f} ms  "
            f"bound {b_ms:.4f} ms ({bound_by}), {100 * b_ms / ms:.1f}% of the bound")
        result[batch] = dict(max_abs_err=max_abs, rel_rms=rel_rms, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=bound_by)
        del noise, routed, scalars
        torch.cuda.empty_cache()
    return result


def _rel_errs(dr_k, ds_k, dr_ref, ds_ref, keep_r=None, keep_s=None):
    """Per signal of d_routed and per used column of d_scalars: max|d| over the
    entries kept, over the largest |reference| of that signal or column."""
    import torch

    if keep_r is not None:
        dr_k, dr_ref = dr_k * keep_r, dr_ref * keep_r
        ds_k, ds_ref = ds_k * keep_s, ds_ref * keep_s
    r = [float((dr_k[:, s] - dr_ref[:, s]).abs().max() / (dr_ref[:, s].abs().max() + 1e-30))
         for s in range(5)]
    s = [float((ds_k[:, i] - ds_ref[:, i]).abs().max() / (ds_ref[:, i].abs().max() + 1e-30))
         for i in range(11)]
    if not (torch.isfinite(dr_k).all() and torch.isfinite(ds_k).all()):
        raise AssertionError("non-finite render backward")
    return r, s


def _check_bwd(what: str, r, s) -> None:
    log(f"[render_bwd] {what}: d_routed per signal {['%.2e' % v for v in r]}; "
        f"d_scalars per column max {max(s):.2e}")
    if max(r) > BWD_TOLERANCE["d_routed"] or max(s) > BWD_TOLERANCE["d_scalars"]:
        raise AssertionError(f"render backward disagrees ({what}): {r} {s}")


def phase_render_bwd() -> dict:
    import torch

    from inverse_audio_synthesis_tpu_torch.ops import render as R

    result = {}
    for batch in (128, 1024):
        cfg, _, routed, scalars, noise = render_inputs(batch, batch_num=42)
        sr = float(cfg.sample_rate)
        g = torch.randn(noise.shape, device="cuda", generator=torch.Generator("cuda").manual_seed(batch))
        _, seg_mean, offset = R.render_audio_fused(routed, scalars, noise, sr, save_phase=True)
        dr_k, ds_k = R.render_audio_fused_bwd(routed, scalars, noise, g, seg_mean, offset, sr)
        dr_p, ds_p = R.render_audio_bwd_plain(routed, scalars, noise, g, seg_mean, offset, sr)
        torch.cuda.synchronize()
        r, s = _rel_errs(dr_k, ds_k, dr_p, ds_p)
        _check_bwd(f"B={batch} kernel vs plain", r, s)
        dr_k2, ds_k2 = R.render_audio_fused_bwd(routed, scalars, noise, g, seg_mean, offset, sr)
        repeat = bool(torch.equal(dr_k, dr_k2) and torch.equal(ds_k, ds_k2))
        log(f"[render_bwd] B={batch} a second launch is bit-identical: {repeat}")
        if not repeat:
            raise AssertionError("the render backward does not repeat bit for bit")
        max_abs = max(float((dr_k - dr_p).abs().max()), float((ds_k - ds_p).abs().max()))
        del dr_p, ds_p, dr_k2, ds_k2
        ms = cuda_time_ms(lambda: R.render_audio_fused_bwd(routed, scalars, noise, g, seg_mean, offset, sr))
        plain_ms = cuda_time_ms(
            lambda: R.render_audio_bwd_plain(routed, scalars, noise, g, seg_mean, offset, sr),
            reps=5 if batch <= 128 else 3, warmup=1,
        )
        b_ms, bound_by = render_bwd_bound_ms(routed, noise, seg_mean)
        log(f"[render_bwd] B={batch} kernel {ms:.4f} ms  plain {plain_ms:.3f} ms  "
            f"bound {b_ms:.4f} ms ({bound_by}), {100 * b_ms / ms:.1f}% of the bound")
        result[batch] = dict(max_abs_err=max_abs, rel_d_routed=max(r), rel_d_scalars=max(s),
                             ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=bound_by)
        del g, seg_mean, offset, dr_k, ds_k, noise, routed, scalars
        torch.cuda.empty_cache()

    # against autograd of the plain forward, exact-tie entries left out
    cfg, _, routed, scalars, noise = render_inputs(16, batch_num=7)
    sr = float(cfg.sample_rate)
    g = torch.randn(noise.shape, device="cuda", generator=torch.Generator("cuda").manual_seed(16))
    _, seg_mean, offset = R.render_audio_fused(routed, scalars, noise, sr, save_phase=True)
    dr_k, ds_k = R.render_audio_fused_bwd(routed, scalars, noise, g, seg_mean, offset, sr)
    r_, s_ = routed.clone().requires_grad_(), scalars.clone().requires_grad_()
    dr_a, ds_a = torch.autograd.grad(R.render_audio_plain(r_, s_, noise, sr), (r_, s_), g)
    tie_r, tie_s = R.gradient_ties(routed, scalars, noise.shape[-1])
    log(f"[render_bwd] B=16 exact-tie entries left out: {int(tie_r.sum())} of d_routed, "
        f"{int(tie_s.sum())} of d_scalars")
    r, s = _rel_errs(dr_k, ds_k, dr_a, ds_a, (~tie_r).float(), (~tie_s).float())
    _check_bwd("B=16 kernel vs autograd of the plain forward", r, s)
    result["autograd_b16"] = dict(rel_d_routed=max(r), rel_d_scalars=max(s))
    del r_, s_, dr_a, ds_a
    torch.cuda.empty_cache()
    return result


class ListLogger:
    def __init__(self):
        self.records = []

    def log(self, metrics, step=None):
        self.records.append({"step": step, **metrics})


def _step_times(steps) -> float:
    return statistics.median(1e3 / r["steps_per_sec"] for r in steps[1:])


def phase_train(ckpt_dir: Path) -> dict:
    import torch

    from inverse_audio_synthesis_tpu_torch.ops import render as R
    from inverse_audio_synthesis_tpu_torch.train.checkpoint import CheckpointManager
    from inverse_audio_synthesis_tpu_torch.train.loop import Trainer
    from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask
    from inverse_audio_synthesis_tpu_torch.train.runsetup import BatchNumberSplit
    from inverse_audio_synthesis_tpu_torch.utils.config import load_config

    cfg = load_config(overrides=[f"vicreg.limit_train_batches={N_STEPS}", "log_every=1"])
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
    checkpoint = CheckpointManager(str(ckpt_dir), every_n_steps=cfg.vicreg.checkpoint_every_nbatches)
    trainer = Trainer(task, split, logger=logger, checkpoint=checkpoint,
                      limit_train_batches=N_STEPS, log_every=1)

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
    if len(steps) != N_STEPS:
        raise AssertionError(f"expected {N_STEPS} logged steps, got {len(steps)}")
    if not all(math.isfinite(r["vicreg/train/loss"]) for r in steps):
        raise AssertionError("non-finite training loss")
    if any(r["notfinite_steps"] != 0 for r in steps):
        raise AssertionError("non-finite updates were rejected")
    if not all(math.isfinite(v) for v in val.values()):
        raise AssertionError("non-finite validation metrics")
    if launches["render_fwd"] < N_STEPS + 1:
        raise AssertionError(f"render kernel launched {launches['render_fwd']} times in "
                             f"{N_STEPS} train steps and one val step")
    if checkpoint.latest_step() != N_STEPS:
        raise AssertionError(f"expected a checkpoint of step {N_STEPS}, found {checkpoint.latest_step()}")
    probe = state.model.projector.lin_final.weight.detach().float().cpu()
    step_ms = _step_times(steps)
    log(f"[train] median step after the first: {step_ms:.1f} ms; launches {launches}; "
        f"checkpoint step {checkpoint.latest_step()} in {checkpoint.dir}")
    del task, state, trainer
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "probe": probe}


def phase_downstream(ckpt_dir: Path, probe) -> dict:
    import torch

    from inverse_audio_synthesis_tpu_torch.ops import render as R
    from inverse_audio_synthesis_tpu_torch.train.checkpoint import CheckpointManager
    from inverse_audio_synthesis_tpu_torch.train.downstream import AudioToParamsTask
    from inverse_audio_synthesis_tpu_torch.train.loop import Trainer
    from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask
    from inverse_audio_synthesis_tpu_torch.train.runsetup import BatchNumberSplit
    from inverse_audio_synthesis_tpu_torch.utils.config import load_config

    cfg = load_config(overrides=[
        "audio_to_params.loss=combined", f"audio_to_params.limit_train_batches={N_STEPS}",
        "log_every=1",
    ])
    a2p = cfg.audio_to_params
    t0 = time.time()
    pretrain_task = VicregPretrainTask(cfg)
    vicreg_state = CheckpointManager(str(ckpt_dir)).restore(pretrain_task.init_state())
    restored = vicreg_state.model.projector.lin_final.weight.detach().float().cpu()
    if vicreg_state.step != N_STEPS or not torch.equal(restored, probe):
        raise AssertionError("the restored VICReg checkpoint differs from the saved model")
    task = AudioToParamsTask(cfg, pretrain_task, vicreg_state)
    del pretrain_task, vicreg_state
    state = task.init_state()
    torch.cuda.synchronize()
    weights = {k: float(v) for k, v in task.loss_weights.items()}
    log(f"[downstream] restored VICReg step {N_STEPS}; loss {task.loss_kind} weights {weights} "
        f"batch {a2p.batch_size} dim {cfg.dim} {cfg.torchsynth.buffer_size_seconds} s "
        f"precision {cfg.precision} render_bwd {task.render_bwd} mel_rows {a2p.mel_rows} "
        f"mel_chunk {a2p.mel_chunk}: set-up {time.time() - t0:.1f} s")
    if not task.fused_render or task.render_bwd != "pallas":
        raise AssertionError("the slice must take the render kernels")
    split = BatchNumberSplit(cfg.num_batches, cfg.ntest_batches, cfg.seed)
    logger = ListLogger()
    trainer = Trainer(task, split, logger=logger, limit_train_batches=N_STEPS, log_every=1)
    frozen_before = [p.detach().clone() for p in task.frozen.parameters()][:4]

    torch.cuda.reset_peak_memory_stats()
    R.reset_launch_counts()
    state = trainer.fit(state)
    metrics, true_audio, pred_audio = task.test_step(state, split.test_batch_num(0))
    metrics = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
    torch.cuda.synchronize()
    launches = dict(R.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    steps = [r for r in logger.records if "audio_to_params/train/loss" in r]
    for r in steps:
        comps = {k.rsplit("/", 1)[1]: r[k] for k in r if k.startswith("audio_to_params/train/")}
        log(f"[downstream] step {r['step']}: " + " ".join(f"{k} {v:.5f}" for k, v in comps.items())
            + f" step {1e3 / r['steps_per_sec']:.1f} ms notfinite {r['notfinite_steps']:.0f}")
        total = sum(w * r[f"audio_to_params/train/{k}"] for k, w in weights.items() if w)
        if not math.isclose(total, r["audio_to_params/train/loss"], rel_tol=1e-5, abs_tol=1e-7):
            raise AssertionError(f"loss {r['audio_to_params/train/loss']} != sum of w * component {total}")
    log("[downstream] test: " + " ".join(f"{k.split('/', 1)[1]}={v:.4f}" for k, v in metrics.items()))
    if len(steps) != N_STEPS:
        raise AssertionError(f"expected {N_STEPS} logged steps, got {len(steps)}")
    if not all(math.isfinite(v) for r in steps for v in r.values() if isinstance(v, float)):
        raise AssertionError("non-finite downstream training metrics")
    if any(r["notfinite_steps"] != 0 for r in steps):
        raise AssertionError("non-finite updates were rejected")
    if not all(math.isfinite(v) for v in metrics.values()) or not torch.isfinite(pred_audio).all():
        raise AssertionError("non-finite test metrics or resynthesized audio")
    if {tuple(pred_audio.shape), tuple(true_audio.shape)} != {(a2p.batch_size, 176400)}:
        raise AssertionError(f"resynthesized audio of shape {tuple(pred_audio.shape)}")
    if not all(torch.equal(a, b) for a, b in zip(frozen_before, list(task.frozen.parameters())[:4])):
        raise AssertionError("the frozen towers changed")
    need_fwd = 2 * N_STEPS + 2
    if launches["render_bwd"] < N_STEPS or launches["render_fwd"] < need_fwd:
        raise AssertionError(f"launches {launches}: need render_bwd >= {N_STEPS}, render_fwd >= {need_fwd}")
    step_ms = _step_times(steps)
    log(f"[downstream] median step after the first: {step_ms:.1f} ms "
        f"({a2p.batch_size / step_ms * 1e3:.0f} voices/s); peak device memory {peak_gb:.1f} GB; "
        f"launches {launches}")
    return {"launches": launches, "step_ms": step_ms, "peak_gb": peak_gb, "test": metrics}


def timed_steps(evaluator) -> list:
    """Record the host time of each of the evaluator's steps (a step ends by
    reading its improvement mask on the host) into the list returned."""
    times, step = [], evaluator.step

    def timed(batch_num):
        t = time.perf_counter()
        mask = step(batch_num)
        times.append(time.perf_counter() - t)
        return mask

    evaluator.step = timed
    return times


def phase_retrieval(ckpt_dir: Path, k1_b128_ms: float) -> dict:
    import numpy as np
    import torch

    from inverse_audio_synthesis_tpu_torch.eval.retrieval import RetrievalEvaluator
    from inverse_audio_synthesis_tpu_torch.ops import render as R
    from inverse_audio_synthesis_tpu_torch.synth.voice import make_noise
    from inverse_audio_synthesis_tpu_torch.train.pretrain import restore_vicreg, synth_config_from_cfg
    from inverse_audio_synthesis_tpu_torch.utils.config import load_config

    cfg = load_config()
    rcfg = cfg.retrieval
    task, state, step = restore_vicreg(cfg, str(ckpt_dir))
    if step != N_STEPS:
        raise AssertionError(f"expected the VICReg checkpoint of step {N_STEPS}, found {step}")
    query_synth = synth_config_from_cfg(cfg, rcfg.test_batch_size)
    candidate_synth = synth_config_from_cfg(cfg, rcfg.predict_batch_size)
    n_sub = rcfg.predict_batch_size // rcfg.inner_chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    make_noise(candidate_synth, "cuda")
    torch.cuda.synchronize()
    noise_ms = (time.perf_counter() - t0) * 1e3

    def evaluator():
        return RetrievalEvaluator(
            lambda audio: task.project_audio(state, audio), query_synth, candidate_synth,
            inner_chunk=rcfg.inner_chunk, device=task.device,
        )

    log(f"[retrieval] restored VICReg step {step}; {rcfg.test_batch_size} queries, batches of "
        f"{rcfg.predict_batch_size} candidates in sub-chunks of {rcfg.inner_chunk}, precision "
        f"{cfg.precision}; candidate noise buffer made once in {noise_ms:.1f} ms")
    n_batches = 3
    with tempfile.TemporaryDirectory(prefix="chip_smoke_retrieval_") as tmp:
        R.reset_launch_counts()
        ev = evaluator()
        ev.assert_planted_queries_found()
        batch_s = timed_steps(ev)
        full = ev.run(n_batches, artifact_dir=str(Path(tmp) / "full"))
        torch.cuda.synchronize()
        launches = dict(R.launch_counts)
        diag, d = ev.planted_query_distance()
        norm = float(np.median(torch.linalg.vector_norm(ev.query_emb.float(), dim=1).cpu().numpy()))
        del ev

        # interrupted after 2 batches, then resumed to 3, as a rerun of the CLI does
        evaluator().run(2, artifact_dir=str(Path(tmp) / "part"), save_state_every=1)
        ev = evaluator()
        resumed_steps = timed_steps(ev)
        resumed = ev.run(n_batches, artifact_dir=str(Path(tmp) / "part"), save_state_every=1)
        del ev
    if len(resumed_steps) != 1:
        raise AssertionError(f"the rerun took {len(resumed_steps)} batches: it did not resume from batch 2")
    off = d[~np.eye(d.shape[0], dtype=bool)]
    log(f"[retrieval] planted self-distances max {diag.max():.4g} median {np.median(diag):.4g}; "
        f"median between queries {np.median(off):.4g}; median query-embedding norm {norm:.4g}")
    hist = full["history"]
    log(f"[retrieval] best distances after {n_batches} batches: {np.round(full['best_dist'], 4).tolist()}; "
        f"NN param-MAE mean {float(full['nn_param_mae'].mean()):.4f}; history rows {hist.shape}")
    if not (full["completed"] and hist.shape == (n_batches, rcfg.test_batch_size)):
        raise AssertionError(f"retrieval did not complete {n_batches} batches: {hist.shape}")
    if not (np.isfinite(full["best_dist"]).all() and np.isfinite(full["best_audio"]).all()):
        raise AssertionError("non-finite retrieval results")
    if not (np.diff(hist, axis=0) <= 1e-6).all() or not ((0 <= full["nn_param_mae"]) & (full["nn_param_mae"] <= 1)).all():
        raise AssertionError("retrieval history not monotone or parameter MAE out of [0, 1]")
    same = {k: bool(np.array_equal(full[k], resumed[k]))
            for k in ("best_dist", "history", "best_audio", "best_params")}
    log(f"[retrieval] resumed after 2 of {n_batches} batches, bit-identical to the uninterrupted run: {same}")
    if not all(same.values()) or resumed["batches_done"] != n_batches:
        raise AssertionError("the resumed retrieval differs from the uninterrupted run")
    need = 2 + n_sub * n_batches
    if launches["render_fwd"] < need:
        raise AssertionError(f"render kernel launched {launches['render_fwd']} times, need >= {need}")
    batch_ms = statistics.median(batch_s[1:]) * 1e3
    share = n_sub * k1_b128_ms / batch_ms
    log(f"[retrieval] per batch of {rcfg.predict_batch_size}: {[round(s * 1e3, 2) for s in batch_s]} ms; "
        f"median after the first {batch_ms:.2f} ms = {rcfg.predict_batch_size / batch_ms * 1e3:.0f} "
        f"candidates/s; K1 {n_sub} x {k1_b128_ms:.4f} ms = {100 * share:.1f}% of a batch; "
        f"launches {launches}")
    return {"launches": launches, "batch_ms": batch_ms, "k1_share": share, "noise_ms": noise_ms,
            "candidates_per_s": rcfg.predict_batch_size / batch_ms * 1e3}


def phase_hear(ckpt_dir: Path) -> None:
    import torch

    from inverse_audio_synthesis_tpu_torch.eval.hear import (
        get_scene_embeddings,
        get_timestamp_embeddings,
        load_model,
    )
    from inverse_audio_synthesis_tpu_torch.synth import prng
    from inverse_audio_synthesis_tpu_torch.utils.config import load_config

    cfg = load_config()
    model = load_model(cfg, str(ckpt_dir))
    w = model.window_samples
    clip = prng.uniform(prng.prng_key(1), (2, int(2.5 * w)), -1.0, 1.0, device="cuda")
    scene = get_scene_embeddings(clip, model)
    get_timestamp_embeddings(clip[:, :w], model)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb, ts = get_timestamp_embeddings(clip, model)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    hop = 2205  # 50 ms at 44.1 kHz
    n_ts = -(-clip.shape[1] // hop)
    if scene.shape != (2, cfg.dim) or emb.shape != (2, n_ts, cfg.dim) or ts.shape != (2, n_ts):
        raise AssertionError(f"HEAR shapes: scene {tuple(scene.shape)}, timestamps {tuple(emb.shape)}")
    if not (torch.isfinite(scene).all() and torch.isfinite(emb).all()):
        raise AssertionError("non-finite HEAR embeddings")
    centers_ms = (torch.arange(n_ts, dtype=torch.float64) * hop + hop // 2) * 1000.0 / model.sample_rate
    if float((ts[0].double().cpu() - centers_ms).abs().max()) > 1e-3:
        raise AssertionError(f"timestamps are not the 50 ms hops' centres: {ts[0, :3].tolist()}")
    # an in-bounds window is the tower on the raw slice it covers; the two run at
    # different batch sizes (128 windows a chunk vs 2) under bf16, so they are
    # held within 3e-2 of the largest value, eight bf16 rounding units (2^-8)
    k = 100
    start = k * hop + hop // 2 - w // 2
    ref = model.embed(clip[:, start : start + w])
    rel = float((emb[:, k] - ref).abs().max() / ref.abs().max())
    log(f"[hear] scene {tuple(scene.shape)}; timestamps {tuple(emb.shape)} at 50 ms hops; window {k} "
        f"vs the tower on its raw slice: max|d| {rel:.3e} of the largest value "
        f"(bit-identical: {bool(torch.equal(emb[:, k], ref))}); {2 * n_ts} timestamp embeddings "
        f"in {dt * 1e3:.1f} ms = {2 * n_ts / dt:.0f}/s")
    if rel > 3e-2:
        raise AssertionError(f"a timestamp window differs from its raw slice by {rel} (bound 3e-2)")


def phase_export(ckpt_dir: Path) -> None:
    import io

    import torch

    from inverse_audio_synthesis_tpu_torch.serve import (
        export_embed_audio,
        export_predict_params,
        export_render,
        load_exported,
        model_weights,
        save_exported,
    )
    from inverse_audio_synthesis_tpu_torch.synth import prng
    from inverse_audio_synthesis_tpu_torch.synth.voice import render_voice, sample_voice_params
    from inverse_audio_synthesis_tpu_torch.train.downstream import AudioToParamsTask
    from inverse_audio_synthesis_tpu_torch.train.pretrain import restore_vicreg
    from inverse_audio_synthesis_tpu_torch.utils.config import load_config

    batch = 16
    cfg = load_config()
    task, state, _ = restore_vicreg(cfg, str(ckpt_dir))
    ds_task = AudioToParamsTask(cfg, task, state)
    head_state = ds_task.init_state()
    audio = prng.uniform(prng.prng_key(2), (batch, 1, task.synth.buffer_size), -1.0, 1.0, device="cuda")
    params01 = sample_voice_params(5, task.synth, "cuda")[:batch]

    def live_predict():
        head_state.model.eval()
        with torch.no_grad(), ds_task._autocast():
            return head_state.model(ds_task._audio_repr(audio).float())

    surfaces = {
        "embed_audio": (lambda: export_embed_audio(task, state, batch),
                        (model_weights(state.model), audio), lambda: task.embed_audio(state, audio)),
        "predict_params": (lambda: export_predict_params(ds_task, head_state, batch),
                           (model_weights(ds_task.frozen), model_weights(head_state.model), audio),
                           live_predict),
        "render": (lambda: export_render(task.synth, batch, "cuda"), (params01,),
                   lambda: render_voice(params01, task.synth)),
    }
    for name, (export, args, live) in surfaces.items():
        t0 = time.time()
        buf = io.BytesIO()
        save_exported(export(), buf)
        size = len(buf.getvalue())
        buf.seek(0)
        with torch.no_grad():
            got = load_exported(buf).module()(*args)
            want = live()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        log(f"[export] {name}: {size} bytes, exported and reloaded in {time.time() - t0:.1f} s; "
            f"output {tuple(got.shape)} {got.dtype} vs the live function max|d| {err:.3e} "
            f"(bit-identical: {bool(torch.equal(got, want))})")
        if got.shape != want.shape or not torch.isfinite(got).all() or err > 2e-6 * max(1.0, float(want.abs().max())):
            raise AssertionError(f"the {name} artifact disagrees with the live function: {err}")
        if size > 8 << 20:  # the audio tower's weights alone are ~100 MB
            raise AssertionError(f"the {name} artifact holds {size} bytes: weights baked in?")


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
    libs = R.build_render_libraries()
    log(f"[build] {', '.join(p.name for p in libs.values())} in {time.time() - t0:.1f} s")
    run = R.run_length(100)  # the 4 s voices' ratio, 176400 / 1764
    resources = {}
    for name, lib in libs.items():
        report = R.ptxas_report(lib.with_suffix(".log").read_text(), run)
        resources[name] = {**report, "blocks_per_sm": R.kernel_occupancy(name),
                           **sass_per_slot(lib, run)}
        log(f"[build] {name} (runs of {run}): {resources[name]}")
        if not report or resources[name]["blocks_per_sm"] < 1:
            raise AssertionError(f"no ptxas report or occupancy for {name}")
    mismatches = R.sequence_mismatches()
    log(f"[build] floats where x / 12, tanh's quotient, mod 2pi and floor differ from IEEE "
        f"division, fmodf and floorf on their domains: {mismatches}")
    if any(mismatches):
        raise AssertionError("the kernels' division, remainder or floor sequences differ")

    render = phase_render()
    render_bwd = phase_render_bwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        ckpt_dir = Path(tmp) / "vicreg"
        train = phase_train(ckpt_dir)
        downstream = phase_downstream(ckpt_dir, train["probe"])
        retrieval = phase_retrieval(ckpt_dir, render[128]["ms"])
        phase_hear(ckpt_dir)
        phase_export(ckpt_dir)

    def entry(name, source, replaces, by_batch, main_batch):
        main = by_batch[main_batch]
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": downstream["launches"][name],
            "max_abs_err": main["max_abs_err"],
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": None,
            "batch": main_batch,
            "share_of_bound": main["bound_ms"] / main["ms"],
            "resources": resources[name],
            "launches_by_path": {"vicreg_pretrain": train["launches"][name],
                                 "downstream_combined": downstream["launches"][name],
                                 "retrieval": retrieval["launches"][name]},
            "by_batch": {str(b): {**{k: v[k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")},
                                  "share_of_bound": v["bound_ms"] / v["ms"]}
                         for b, v in by_batch.items() if isinstance(b, int)},
        }

    kernels = [
        entry("render_fwd", "inverse_audio_synthesis_tpu_torch/csrc/render_fwd.cu",
              "inverse_audio_synthesis_tpu/ops/pallas/render.py:137", render, 1024),
        entry("render_bwd", "inverse_audio_synthesis_tpu_torch/csrc/render_bwd.cu",
              "inverse_audio_synthesis_tpu/ops/pallas/render.py:339", render_bwd, 1024),
    ]
    kernels[0]["pretrain_step_ms"] = train["step_ms"]
    kernels[1]["downstream_step_ms"] = downstream["step_ms"]
    kernels[0]["retrieval"] = {k: retrieval[k] for k in ("batch_ms", "candidates_per_s", "k1_share", "noise_ms")}
    print(json.dumps({"kernels": kernels}))
    print(smi)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
