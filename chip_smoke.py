#!/usr/bin/env python3
"""Smoke run of the PyTorch port (inverse_audio_synthesis_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device and build: the card's name and power limit, then the kernels built
     with nvcc from csrc/render_fwd.cu, csrc/render_bwd.cu and csrc/lars.cu
     (sm_90a), one nvcc process each, started together; each render kernel's registers, shared memory
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
  2b. the JAX package's committed probes (tests/golden/torchsynth_probes: 4
     probes of 4 voices at 4 s / 44.1 kHz / 441 Hz): compute_controls on the
     card from each probe's params01, then K1 through render_voice_fused (one
     launch per probe, noise rows 0-3, the counters reset just before and read
     just after) and the portable render_voice on the card, held at
     tests/test_torch_port_golden.py's bounds: natural values within 1e-5,
     midi_f0 within 1e-6, routed within 2e-5 but at one control sample per
     voice at most, float16 audio within 2e-3 over the first 0.25 s and 0.1
     rel-rms per voice over 4 s, K1 and the portable render within 0.08 / 0.01;
     per probe the routed max, its exceedances, the audio max over the first
     0.25 s and at 4 s and the per-voice rel-rms;
  3. the render backward kernel (K2) against its plain version at batch 128 and
     1024 (d_routed within 5e-4 and d_scalars within 1e-4 of each signal's and
     column's largest value), against autograd of the plain forward at batch 16
     (the same bounds, exact-tie entries left out: there autograd of a clamp
     passes the gradient and the kernel's strict masks do not), and the times of
     both beside the bound;
  3b. the LARS step (csrc/lars.cu, three launches) at the parameter lists of
     vicreg-full and vicreg-ast (random float32 weights and gradients, the full
     config's LARS with grads_bf16): the kernels' registers and blocks per SM;
     the norms within 2e-6 of the plain norm and fold stages' (ops/lars.py),
     the count advanced by one and nothing counted non-finite, the update
     bit-identical to the plain stages' given the kernel's norms; one step's time through the kernels and through the plain
     stages, each replayed as a CUDA graph, beside the two-pass bound (20 bytes
     a parameter), L2 flushed;
  4. four VICReg training steps of the full default config (vicreg=full,
     precision bf16) through Trainer.fit, then one validation step, with the
     launch counters reset just before and read just after (LARS through its
     kernels: three launches a step); the run writes a VICReg checkpoint to a
     temporary directory;
  5. steps_per_dispatch and the rest of the training surface, at the full
     default config: (a) graph parity, f32 with TF32 off and dropout 0.1: 8
     steps with steps_per_dispatch=1 against 8 with 4 and log_every 4
     (dispatches of 1, 3 and 4 steps; the 3 and 4 replay CUDA graphs): the same
     logged steps, losses within rtol 1e-4 (a control run whose dropout masks
     are all others must move them by more), parameters and BatchNorm
     statistics within phase 10's bound, the same optimizer count, no
     rejection and as many K1 launches (a replay counts the launches its graph
     recorded); (b) bf16, 32 steps with 1 and with 4: the median ms a step over
     the last 16 (the first 16 capture the graphs), the host's time to return
     from a dispatch, the host's launch calls per step (cudaLaunchKernel,
     cudaGraphLaunch), the device's idle share and the peak memory, no
     threshold; (c) weights_bf16,
     4 steps: finite, no rejection, every >=2-D parameter bf16 and equal to
     bf16(master), the masters restored bit for bit from a checkpoint; (d) the
     committed vision-trunk fixture loaded through vicreg.vision_weights_path:
     every trunk leaf on the card equals the file, one step finite; (e) a 2-step
     fit inside utils/profiling.py:trace: the trace file's kernel events name
     render_kernel; (f) detect_anomaly: two steps finite in anomaly mode (the
     second timed), which is off again after;
  6. the downstream slice: that checkpoint restored into a fresh
     VicregPretrainTask, then four AudioToParamsTask train steps of the default
     downstream config with audio_to_params.loss=combined (batch 1024, dim 1024,
     4 s voices, bf16) through Trainer.fit, then one test step, with the counters
     reset just before and read just after;
  7. the retrieval eval at the full default config from that checkpoint: the
     planted-query gate, 3 batches of 1024 candidates (16 queries, sub-chunks of
     128, each rendered by K1) through RetrievalEvaluator.run with the counters
     reset just before and read just after (K1 >= 2 + 8 per batch), monotone and
     finite results, ms per batch and candidates/s; then 2 batches with
     save_state_every=1 and a resume to 3, bit-identical to the uninterrupted run;
  8. HEAR: scene and 50 ms timestamp embeddings of two 2.5-window clips, their
     shapes, spacing, a window against the tower on its raw slice, and
     timestamp embeddings per second;
  9. export: embed_audio, predict_params (a fresh head on the frozen towers) and
     render exported with torch.export, saved, reloaded and run on the card
     against the live functions;
 10. the multi-rank path (inverse_audio_synthesis_tpu_torch/parallel), with the
     kernels built above before any rank starts: a plain one-process run (no
     process group) of 8 bf16 pretraining steps (timing), then, with
     precision=f32 and TF32 off for matmuls and cuDNN, 2 VICReg steps and a val
     step at the full config (param_embed.dropout 0.1), a downstream test step,
     one train step and a test step at batch 1024 for the combined objective
     and for param_mse, and 2 retrieval batches of 1024 candidates; then the
     same runs on (a) one rank over NCCL, (b) 2 ranks (mesh data=2 model=1) and
     4 ranks (data=2 model=2) sharing the card over gloo. Held against the
     plain run: each rank's K1 audio rows and K2 d_routed/d_scalars rows bit
     for bit; every metric within rtol 2e-4 / atol 1e-5 (the test steps before
     the update, and param_mse's after it); pretraining's and param_mse's
     reduced gradient (norm within 1%, each tensor within 5%) and parameters
     after one step (max(4e-6, 5% of the update), 25% for 1-D; the full
     config's warmup gives the first pretraining step a learning rate of 0, so
     there the gradient is the check); the combined step's gradient
     norm within a factor 3/2 (its update is ill-conditioned: the plain run
     measures how far a one-ulp change of the head's input moves it); the same
     retrieved candidates. Printed per world: the backend, per rank K1/K2
     launches, all_reduce calls and bytes per step, peak memory and step times
     (ranks sharing one card over gloo: not a scaling figure); and the bf16
     default config's pretraining step time on one NCCL rank beside the same
     steps without a process group;
 11. one JSON line listing every ported kernel with its launches and times.
The whole run's wall time is printed before the JSON line. The last line is
{"ok": true, "device": {...}}. Any failure exits non-zero and
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
# the synth against the JAX package's committed probes: tests/test_torch_port_golden.py's bounds
GOLDEN_PROBES = ("batch0", "batch1", "mid", "corners")
GOLDEN_TOLERANCE = {"natural": 1e-5, "midi_f0": 1e-6, "routed": 2e-5, "routed_exceedances": 1,
                    "head_max": 2e-3, "voice_rel_rms": 0.1, "paths_max": 0.08, "paths_rel_rms": 0.01}
GOLDEN_HEAD = 11_025  # the first 0.25 s


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


LARS_MODELS = {"vicreg-full": ["vicreg=full"], "vicreg-ast": ["vicreg=full", "audio_tower.name=ast"]}
LARS_BYTES_PER_PARAM = 20  # two passes over float32 g and w: read g, w; read g, w, write w


def _lars_ptxas(log_text: str) -> dict:
    """Registers and spill stores of each lars_* kernel (by its table's capacity)
    in nvcc's -Xptxas -v output."""
    entry, found = None, {}
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"(lars_[a-z]+)_kernel(?:ILi(\d+)E)?", m.group(1))
            entry = None if k is None else k[1] + (f"<{k[2]}>" if k[2] else "")
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            found.setdefault(entry, {})["spill_stores"] = int(m[1])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.setdefault(entry, {})["registers"] = int(m[1])
    return found


def _graphed(fn):
    """``fn`` (run once eagerly first) captured into a CUDA graph; its launches
    are recorded, not counted."""
    import torch

    from inverse_audio_synthesis_tpu_torch.ops import launches

    fn()
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with launches.recording_launches(), torch.cuda.graph(graph, stream=stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    return graph


def phase_lars() -> dict:
    """The LARS step of csrc/lars.cu at the parameter lists of vicreg-full and
    vicreg-ast (the port's models built on the meta device; random float32 weights
    and gradients; the full config's LARS, schedule and grads_bf16): the kernels'
    norms within 2e-6 of the plain norm and fold stages' on the same gradients, the
    count advanced by one and nothing counted non-finite, the update bit for bit
    the plain stages' given the kernel's norms; then one step's
    device time through the kernels (three launches), through the plain stages on
    the card, each timed as a CUDA graph's replay, and the two-pass bound, 20
    bytes a parameter at the memory rate."""
    import torch

    from inverse_audio_synthesis_tpu_torch.ops import build
    from inverse_audio_synthesis_tpu_torch.ops import lars as L
    from inverse_audio_synthesis_tpu_torch.train.optim import make_optimizer, schedule_value
    from inverse_audio_synthesis_tpu_torch.train.pretrain import build_vicreg_model
    from inverse_audio_synthesis_tpu_torch.utils.config import load_config

    result = {"ptxas": _lars_ptxas(build.build_libraries(("lars",))["lars"].with_suffix(".log").read_text()),
              "blocks_per_sm": {"norm": L.kernel_occupancy(False), "update": L.kernel_occupancy(True)}}
    log(f"[lars] ptxas {result['ptxas']}; blocks per SM {result['blocks_per_sm']}")
    for model, overrides in LARS_MODELS.items():
        cfg = load_config(overrides=overrides)
        with torch.device("meta"):
            shapes = [(n, p.shape) for n, p in build_vicreg_model(cfg).named_parameters()]
        gen = torch.Generator(device="cuda").manual_seed(7)
        params = [torch.randn(s, generator=gen, device="cuda") * 0.05 for _, s in shapes]
        grads = [torch.randn(s, generator=gen, device="cuda") * 1e-3 for _, s in shapes]
        copy = [p.clone() for p in params]
        names = [n for n, _ in shapes]

        def make(ps):
            opt, schedule = make_optimizer(cfg.vicreg.optim, cfg.vicreg.batch_size, ps, cfg.vicreg.scheduler,
                                           names=names, grads_bf16=True)
            opt.count.fill_(500)  # mid warm-up: a learning rate above 0
            return opt, schedule

        opt, schedule = make(params)
        plain, _ = make(copy)
        lr = schedule_value(schedule, opt.count)
        L.reset_launch_counts()
        opt.step(grads)
        # the norm pass and the fold against the plain stages on the same gradients
        want = L.fold_plain(plain._plan, L.norm_partials_plain(plain._plan, grads)).double()
        norm_err = float(((opt._plan.norms.double() - want).abs() / want.clamp_min(1e-30)).max())
        norms_ok = bool(((opt._plan.norms.double() - want).abs() <= 2e-6 * want).all())
        local_lr, wdc, neglr, ok = L.factors_plain(plain._plan, opt._plan.norms, lr)
        for p, u in zip(copy, L.updates_plain(plain._plan, grads, local_lr, wdc, neglr, ok)):
            p.add_(u)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(params, copy))
        launched = dict(L.launch_counts)
        count, notfinite = int(opt.count), int(opt.total_notfinite)
        log(f"[lars] {model}: {len(params)} tensors, {opt._plan.n_chunks} chunks; norms vs the plain stages' "
            f"max rel {norm_err:.2e} (limit 2e-6); kernel vs plain update bit-identical given its norms: "
            f"{same}; count 500 -> {count}, non-finite {notfinite}; launches {launched}")
        if (not same or not norms_ok or count != 501 or notfinite != 0
                or launched != {"lars_norm": 1, "lars_fold": 1, "lars_update": 1} or opt.path != "kernel"):
            raise AssertionError(f"the LARS kernels disagree with their plain stages at {model}")
        del copy, plain
        n = sum(p.numel() for p in params)

        def plain_step():
            for p, u in zip(opt.params, opt.updates(grads)):
                p.add_(u)

        # each step as a CUDA graph's replay, as the pretraining cells run it: the
        # device's time, without the host's between the launches
        ms = cuda_time_ms(_graphed(lambda: opt.step(grads)).replay)
        plain_ms = cuda_time_ms(_graphed(plain_step).replay, reps=10, warmup=2)
        b_ms, _ = bound_ms(LARS_BYTES_PER_PARAM * n, 0.0)
        log(f"[lars] {model}: {n} parameters; kernel {ms:.4f} ms  plain {plain_ms:.3f} ms  "
            f"bound {b_ms:.4f} ms (bytes, 20 a parameter), {100 * b_ms / ms:.1f}% of the bound")
        result[model] = dict(params=n, tensors=len(params), chunks=opt._plan.n_chunks, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by="bytes", max_abs_err=0.0, norm_rel_err=norm_err)
        del opt, params, grads
        torch.cuda.empty_cache()
    return result


def _voice_rel_rms(ref, x):
    """Per voice (row) rms(x - ref) / rms(ref), numpy."""
    import numpy as np

    return np.sqrt(np.mean((x - ref) ** 2, axis=-1)) / (np.sqrt(np.mean(ref**2, axis=-1)) + 1e-12)


def phase_golden() -> dict:
    """The JAX package's committed probes through compute_controls and K1 on the
    card at 4 s, and through the portable render on the card."""
    import numpy as np
    import torch

    from inverse_audio_synthesis_tpu_torch.ops import render as R
    from inverse_audio_synthesis_tpu_torch.synth import SynthConfig, from_0to1
    from inverse_audio_synthesis_tpu_torch.synth.voice import (
        VOICE_PARAM_SPECS,
        compute_controls,
        make_noise,
        render_voice,
        render_voice_fused,
    )

    tol = GOLDEN_TOLERANCE
    probe_dir = Path(__file__).resolve().parent / "tests" / "golden" / "torchsynth_probes"
    probes = {name: dict(np.load(probe_dir / f"probe_{name}.npz")) for name in GOLDEN_PROBES}
    cfg = SynthConfig(batch_size=4, buffer_size_seconds=4.0)
    noise = make_noise(cfg, "cuda")
    inputs = {name: torch.from_numpy(d["params01"]).cuda() for name, d in probes.items()}
    torch.cuda.synchronize()
    R.reset_launch_counts()
    k1 = {name: render_voice_fused(p, cfg, noise) for name, p in inputs.items()}
    torch.cuda.synchronize()
    launches = dict(R.launch_counts)
    if launches["render_fwd"] != len(GOLDEN_PROBES):
        raise AssertionError(f"K1 launches {launches}, need one per probe")
    out = {"launches": launches, "probes": {}}
    for name, d in probes.items():
        params01 = inputs[name]
        natural = torch.stack([from_0to1(s, params01[:, i]) for i, s in enumerate(VOICE_PARAM_SPECS)], 1)
        _, routed, midi_f0 = compute_controls(params01, cfg)
        nat_err = np.abs(natural.cpu().numpy() - d["natural"]) - tol["natural"] * np.abs(d["natural"])
        f0_err = float(np.abs(midi_f0.cpu().numpy() - d["midi_f0"]).max())
        r_err = np.abs(routed.cpu().numpy() - d["routed"]).max(axis=1)  # [voice, control sample]
        over = [np.nonzero(r_err[v] > tol["routed"])[0].tolist() for v in range(r_err.shape[0])]
        exceed = [(v, t, float(r_err[v, t])) for v in range(len(over)) for t in over[v]]
        ref = d["audio"].astype(np.float32)
        audio = {"k1": k1[name].cpu().numpy(), "portable": render_voice(params01, cfg, noise).cpu().numpy()}
        row = {"routed_max": float(r_err.max()), "routed_exceedances": exceed, "midi_f0_max": f0_err}
        for path, a in audio.items():
            if a.shape != ref.shape or not np.isfinite(a).all():
                raise AssertionError(f"probe {name} {path}: audio not finite or of shape {a.shape}")
            q = a.astype(np.float16).astype(np.float32)
            row[path] = {"head_max": float(np.abs(q[:, :GOLDEN_HEAD] - ref[:, :GOLDEN_HEAD]).max()),
                         "max_4s": float(np.abs(q - ref).max()),
                         "voice_rel_rms": [float(v) for v in _voice_rel_rms(ref, q)]}
        row["paths_max"] = float(np.abs(audio["k1"] - audio["portable"]).max())
        row["paths_rel_rms"] = float(_voice_rel_rms(audio["k1"], audio["portable"]).max())
        log(f"[golden] {name}: routed max {row['routed_max']:.3e}, beyond {tol['routed']} at "
            f"(voice, control sample, diff) {[(v, t, f'{e:.3e}') for v, t, e in exceed]}; "
            f"midi_f0 max {f0_err:.1e}")
        for path in ("k1", "portable"):
            log(f"[golden] {name} {path}: audio max first 0.25 s {row[path]['head_max']:.3e}, at 4 s "
                f"{row[path]['max_4s']:.3e}; per-voice rel-rms {['%.4f' % v for v in row[path]['voice_rel_rms']]}")
        log(f"[golden] {name} K1 vs portable on the card: max {row['paths_max']:.3e}, "
            f"rel-rms {row['paths_rel_rms']:.3e}")
        if nat_err.max() > tol["natural"] or f0_err > tol["midi_f0"]:
            raise AssertionError(f"probe {name}: natural values or midi_f0 beyond the bound")
        if max(len(o) for o in over) > tol["routed_exceedances"]:
            raise AssertionError(f"probe {name}: routed beyond {tol['routed']} at {over}")
        for path in ("k1", "portable"):
            if row[path]["head_max"] > tol["head_max"] or max(row[path]["voice_rel_rms"]) > tol["voice_rel_rms"]:
                raise AssertionError(f"probe {name} {path}: audio beyond the probe bounds: {row[path]}")
        if row["paths_max"] > tol["paths_max"] or row["paths_rel_rms"] > tol["paths_rel_rms"]:
            raise AssertionError(f"probe {name}: K1 and the portable render disagree: {row}")
        out["probes"][name] = row
    del k1, noise, inputs
    torch.cuda.empty_cache()
    return out


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

    from inverse_audio_synthesis_tpu_torch.ops import lars as L
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
    L.reset_launch_counts()
    state = trainer.fit(state)
    val = task.val_step(state, split.val_batch_num(0))
    val = {k: float(v) for k, v in val.items()}
    torch.cuda.synchronize()
    launches = dict(R.launch_counts)
    lars_launches = dict(L.launch_counts)

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
    if state.optimizer.path != "kernel" or lars_launches != dict.fromkeys(L.launch_counts, N_STEPS):
        raise AssertionError(f"LARS took the {state.optimizer.path} path, launches {lars_launches}")
    if checkpoint.latest_step() != N_STEPS:
        raise AssertionError(f"expected a checkpoint of step {N_STEPS}, found {checkpoint.latest_step()}")
    probe = state.model.projector.lin_final.weight.detach().float().cpu()
    step_ms = _step_times(steps)
    log(f"[train] median step after the first: {step_ms:.1f} ms; launches {launches}, LARS {lars_launches}; "
        f"checkpoint step {checkpoint.latest_step()} in {checkpoint.dir}")
    del task, state, trainer
    torch.cuda.empty_cache()
    return {"launches": launches, "lars_launches": lars_launches, "step_ms": step_ms, "probe": probe}


DISPATCH_STEPS = 8  # (a): 8 steps with k = 1 against k = 4 and log_every 4: dispatches 1, 3, 4
TIMING_DISPATCH_STEPS = 16


def _pretrain_fit(overrides, steps, k, log_every, logger=None, checkpoint=None):
    """(task, trainer, state, logger): a pretraining task of the full default
    config with ``overrides``, its fresh state, and a Trainer of ``steps`` steps
    with ``steps_per_dispatch`` k that logs into ``logger``."""
    from inverse_audio_synthesis_tpu_torch.train.loop import Trainer
    from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask
    from inverse_audio_synthesis_tpu_torch.train.runsetup import BatchNumberSplit
    from inverse_audio_synthesis_tpu_torch.utils.config import load_config

    cfg = load_config(overrides=list(overrides))
    task = VicregPretrainTask(cfg)
    state = task.init_state()
    logger = logger or ListLogger()
    trainer = Trainer(task, BatchNumberSplit(cfg.num_batches, cfg.ntest_batches, cfg.seed), logger=logger,
                      checkpoint=checkpoint, limit_train_batches=steps, log_every=log_every,
                      steps_per_dispatch=k)
    return task, trainer, state, logger


def _host_state(state) -> dict:
    return {k: v.detach().float().cpu() for k, v in state.model.state_dict().items()}


def phase_dispatch() -> dict:
    """steps_per_dispatch as a CUDA graph around K1, weights_bf16, the vision trunk
    import, profile_dir and detect_anomaly, at the full default config (see the
    module docstring, item 5)."""
    import importlib.util
    import statistics as st

    import numpy as np
    import torch

    from inverse_audio_synthesis_tpu_torch.models.jax_weights import export_jax_variables, flatten
    from inverse_audio_synthesis_tpu_torch.models.torch_import import load_vision_weights_file
    from inverse_audio_synthesis_tpu_torch.ops import render as R
    from inverse_audio_synthesis_tpu_torch.train.checkpoint import CheckpointManager
    from inverse_audio_synthesis_tpu_torch.utils.profiling import nan_debugging, trace

    t_phase = time.time()
    out = {}
    # (a) graph parity: f32, TF32 off, dropout at its default (0.1)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    runs = {}
    try:
        # "shifted": k = 1 with the dropout generator one draw ahead, so every mask
        # is another: the control that the losses' tolerance would catch masks
        # replayed out of eager order
        for name, k in (("one", 1), ("four", 4), ("shifted", 1)):
            task, trainer, state, logger = _pretrain_fit(
                ["precision=f32", f"vicreg.limit_train_batches={DISPATCH_STEPS}"], DISPATCH_STEPS, k, 4)
            if name == "shifted":
                torch.rand(1, device="cuda", generator=state.model.backbone_param.block1.do.generator)
            init = _host_state(state)
            R.reset_launch_counts()
            state = trainer.fit(state)
            torch.cuda.synchronize()
            runs[name] = {"launches": dict(R.launch_counts), "state": _host_state(state), "init": init,
                          "rows": [r for r in logger.records if "vicreg/train/loss" in r],
                          "count": int(state.optimizer.count), "step": state.step,
                          "path": task.dispatch_path, "graphs": sorted(task._graphs)}
            del task, trainer, state
            _release_cuda()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    one, four = runs["one"], runs["four"]
    shifted = max(abs(b["vicreg/train/loss"] / a["vicreg/train/loss"] - 1.0)
                  for a, b in zip(one["rows"], runs["shifted"]["rows"]))
    if not shifted > 1e-4:
        raise AssertionError(f"other dropout masks moved the losses by {shifted:.2e}: the parity check "
                             f"cannot tell the masks' order")
    log(f"[dispatch] k=4 path: {four['path']}; graphs captured for dispatch lengths {four['graphs']}")
    if not four["path"].startswith("cuda graph") or four["graphs"] != [3, 4]:
        raise AssertionError("steps_per_dispatch=4 did not replay graphs of 3 and 4 steps")
    if [r["step"] for r in one["rows"]] != [r["step"] for r in four["rows"]] or len(one["rows"]) != 3:
        raise AssertionError(f"logged steps differ: {[r['step'] for r in one['rows']]} vs "
                             f"{[r['step'] for r in four['rows']]}")
    for a, b in zip(one["rows"], four["rows"]):
        for key in ("vicreg/train/loss", "vicreg/train/repr_loss", "vicreg/train/std_loss",
                    "vicreg/train/cov_loss", "lr"):
            if not math.isclose(a[key], b[key], rel_tol=1e-4, abs_tol=1e-9):
                raise AssertionError(f"step {a['step']} {key}: k=1 {a[key]} vs k=4 {b[key]}")
        if a["notfinite_steps"] or b["notfinite_steps"]:
            raise AssertionError("non-finite updates were rejected")
    worst = _close_params(one["state"], four["state"], one["init"], "graph parity")
    identical = all(torch.equal(one["state"][k], four["state"][k]) for k in one["state"])
    if one["count"] != four["count"] or {one["step"], four["step"]} != {DISPATCH_STEPS}:
        raise AssertionError(f"optimizer count {one['count']} vs {four['count']}, steps {one['step']} vs {four['step']}")
    if one["launches"]["render_fwd"] != four["launches"]["render_fwd"] or one["launches"]["render_fwd"] < DISPATCH_STEPS:
        raise AssertionError(f"K1 launches: k=1 {one['launches']} vs k=4 {four['launches']}")
    log(f"[dispatch] (a) graph parity, f32 and TF32 off, dropout 0.1, {DISPATCH_STEPS} steps, log_every 4: "
        f"logged steps {[r['step'] for r in four['rows']]}, losses "
        f"{[round(r['vicreg/train/loss'], 6) for r in one['rows']]} (k=1) vs "
        f"{[round(r['vicreg/train/loss'], 6) for r in four['rows']]} (k=4); parameters and BatchNorm "
        f"statistics at {worst:.3f} of their bound (bit-identical: {identical}); optimizer count "
        f"{four['count']}, no rejection; K1 launches {one['launches']['render_fwd']} (k=1) and "
        f"{four['launches']['render_fwd']} (k=4, counted per replay); the replayed dropout masks "
        f"follow eager order (the masks of a generator one draw ahead move the losses by up to "
        f"{shifted:.2e})")
    out["graph_launches"] = four["launches"]
    del runs, one, four
    _release_cuda()

    # (b) timing at the bf16 default config
    spec = importlib.util.spec_from_file_location(
        "profile_torch_port_step", Path(__file__).resolve().parent / "tools" / "profile_torch_port_step.py")
    prof_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof_tool)
    timing = {}
    for k in (1, 4):
        # 16 steps from the first (k=4: dispatches of 1, 3, 4, 4, 4; the 3 and the
        # first 4 capture their graphs), then the 16 timed ones (k=4: four replays)
        n = 2 * TIMING_DISPATCH_STEPS
        task, trainer, state, _ = _pretrain_fit([], n, k, 4)
        i, times, enqueue = 0, [], []
        torch.cuda.reset_peak_memory_stats()
        while i < n:
            d = trainer._dispatch_len(i, n, 0) if k > 1 else 1
            t0 = time.perf_counter()
            if d > 1:
                state, m = task.train_step_multi(state, list(range(1000 + i, 1000 + i + d)))
            else:
                state, m = task.train_step(state, 1000 + i)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            times.append(((time.perf_counter() - t0) * 1e3 / d, d, i >= TIMING_DISPATCH_STEPS))
            enqueue.append((t1 - t0) * 1e3 / d)
            i += d
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        timed = [j for j, t in enumerate(times) if t[2]]
        step_ms = st.median(times[j][0] for j in timed)
        enqueue_ms = st.median(enqueue[j] for j in timed)
        first_ms = [round(t, 2) for t, _, late in times if not late]

        def window():
            nonlocal state
            for j in range(2):
                if k > 1:
                    state, _ = task.train_step_multi(state, list(range(2000 + 4 * j, 2004 + 4 * j)))
                else:
                    for b in range(2000 + 4 * j, 2004 + 4 * j):
                        state, _ = task.train_step(state, b)
            torch.cuda.synchronize()

        figures, _, _ = prof_tool.profile_window(window, 8, step_ms)
        timing[k] = {"step_ms": step_ms, "enqueue_ms": enqueue_ms, "dispatches": [d for _, d, _ in times],
                     "first_16_ms_per_step": first_ms, "peak_gb": peak_gb, **figures}
        log(f"[dispatch] (b) bf16 default config, batch 16, steps_per_dispatch={k}: median "
            f"{step_ms:.2f} ms a step over steps 16-31 (host {enqueue_ms:.2f} ms a step to return from the "
            f"dispatch; dispatches {timing[k]['dispatches']}; steps 0-15, captures included, ms a step by "
            f"dispatch {first_ms}); "
            f"host launch calls per step {figures['host_launch_calls_per_step']}; kernels on the card per "
            f"step {figures['kernel_launches_per_step']}; device busy {figures['device_busy_ms_per_step']} ms "
            f"a step, idle share {figures['device_idle_share']}; peak memory {peak_gb:.2f} GB")
        del task, trainer, state
        _release_cuda()
    out["timing"] = timing

    # (c) weights_bf16: 4 steps, bf16 storage, masters, a checkpoint round trip
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_") as tmp:
        ckpt = CheckpointManager(tmp, every_n_steps=1000)
        task, trainer, state, logger = _pretrain_fit(["weights_bf16=true", "vicreg.limit_train_batches=4"],
                                                     4, 1, 1, checkpoint=ckpt)
        state = trainer.fit(state)
        rows = [r for r in logger.records if "vicreg/train/loss" in r]
        opt = state.optimizer
        narrow = [state.optimizer.params[i] for i in opt.narrow]
        if len(rows) != 4 or not all(math.isfinite(r["vicreg/train/loss"]) and r["notfinite_steps"] == 0 for r in rows):
            raise AssertionError(f"weights_bf16 steps: {rows}")
        if any(p.dtype != (torch.bfloat16 if p.dim() >= 2 else torch.float32) for p in state.model.parameters()):
            raise AssertionError("weights_bf16: >=2-D parameters must be bf16, 1-D float32")
        if not all(torch.equal(opt.params[i], opt.master[i].to(torch.bfloat16)) for i in opt.narrow):
            raise AssertionError("weights_bf16: a stored parameter differs from bf16(master)")
        fresh_task, fresh_trainer, fresh, _ = _pretrain_fit(["weights_bf16=true"], 4, 1, 1)
        fresh = CheckpointManager(tmp).restore(fresh)
        if not all(torch.equal(a, b) for a, b in zip(opt.master, fresh.optimizer.master)):
            raise AssertionError("weights_bf16: the checkpoint did not restore the masters exactly")
        log(f"[dispatch] (c) weights_bf16, bf16 precision, 4 steps: losses "
            f"{[round(r['vicreg/train/loss'], 4) for r in rows]}, no rejection; {len(narrow)} of "
            f"{len(opt.params)} parameters stored in bf16, each equal to bf16(master); a checkpoint "
            f"round trip restores the masters bit for bit")
        del task, trainer, state, fresh_task, fresh_trainer, fresh, opt, narrow
        _release_cuda()

    # (d) the vision trunk from the committed fixture
    fixture = Path(__file__).resolve().parent / "tests" / "golden" / "vision_trunk_fixture.pkl"
    task, trainer, state, _ = _pretrain_fit([f"vicreg.vision_weights_path={fixture}"], 1, 1, 1)
    params, stats = load_vision_weights_file(str(fixture))
    want = flatten({"params": params, "batch_stats": stats})
    got = flatten(export_jax_variables(state.model.backbone_audio.vision_model,
                                       {"params": params, "batch_stats": stats}))
    if set(got) != set(want) or not all(np.array_equal(got[k], want[k]) for k in want):
        raise AssertionError("the vision trunk on the card differs from the fixture")
    state, m = task.train_step(state, 0)
    if not math.isfinite(float(m["vicreg/train/loss"])):
        raise AssertionError("non-finite step from the fixture trunk")
    log(f"[dispatch] (d) vicreg.vision_weights_path: all {len(want)} trunk leaves on the card equal "
        f"the fixture; one step loss {float(m['vicreg/train/loss']):.4f}")
    del task, trainer, state
    _release_cuda()

    # (e) profile_dir: a 2-step fit inside trace()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        task, trainer, state, _ = _pretrain_fit(["vicreg.limit_train_batches=2"], 2, 1, 1)
        with trace(tmp, cuda=True):
            trainer.fit(state)
        files = list(Path(tmp).glob("trace-*.json"))
        if len(files) != 1:
            raise AssertionError(f"expected one trace file, found {files}")
        events = json.loads(files[0].read_text()).get("traceEvents", [])
        k1 = [e for e in events if e.get("cat") == "kernel" and "render_kernel" in e.get("name", "")]
        if not k1:
            raise AssertionError("the trace's kernel events do not name render_kernel")
        log(f"[dispatch] (e) profile_dir: {files[0].name} ({files[0].stat().st_size} bytes, "
            f"{len(events)} events); {len(k1)} kernel events name render_kernel")
        del task, trainer, state
        _release_cuda()

    # (f) detect_anomaly: two steps in anomaly mode (the second timed), off again after
    with nan_debugging():
        task, trainer, state, _ = _pretrain_fit(["detect_anomaly=true"], 2, 4, 1)
        state, m0 = task.train_step_multi(state, [0])
        t0 = time.perf_counter()
        state, m = task.train_step_multi(state, [1])
        torch.cuda.synchronize()
        anomaly_ms = (time.perf_counter() - t0) * 1e3
    losses = m0["vicreg/train/loss"].tolist() + m["vicreg/train/loss"].tolist()
    if torch.is_anomaly_enabled() or not task.dispatch_path.startswith("eager"):
        raise AssertionError(f"anomaly mode left on, or path {task.dispatch_path}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite step in anomaly mode")
    log(f"[dispatch] (f) detect_anomaly: path {task.dispatch_path}; losses "
        f"{[round(v, 4) for v in losses]}; the second step {anomaly_ms:.1f} ms "
        f"({anomaly_ms / timing[1]['step_ms']:.2f}x (b)'s k=1 step); anomaly mode off after")
    del task, trainer, state
    _release_cuda()
    log(f"[dispatch] phase time {time.time() - t_phase:.1f} s")
    return out


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
    if task.synth_calls != {"replayed": N_STEPS - 1, "eager": 1}:
        raise AssertionError(f"train step synths {task.synth_calls}: expected one eager, then replays")
    step_ms = _step_times(steps)
    log(f"[downstream] median step after the first: {step_ms:.1f} ms "
        f"({a2p.batch_size / step_ms * 1e3:.0f} voices/s); peak device memory {peak_gb:.1f} GB; "
        f"launches {launches}; train step synths {task.synth_calls} ({task.synth_path})")
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


PARALLEL_WORLDS = (("1 rank, NCCL", 1, 1, "nccl"), ("2 ranks (2x1), gloo", 2, 1, "gloo"),
                   ("4 ranks (2x2), gloo", 2, 2, "gloo"))
PARALLEL_F32 = ["precision=f32", "audio_to_params.mel_chunk=64"]
PARALLEL_BATCHES = (11, 12)
TIMING_STEPS = 8
RUNS = ("timing", "pretrain", "combined", "param_mse", "retrieval")


def _parallel_calls(mesh, keep_init=False):
    """The runs each world and the plain process make, in the order of RUNS: bf16
    timing steps at torch's defaults, then the f32 comparisons."""
    f32 = PARALLEL_F32 + mesh
    down = dict(batch_num=14, test_batch=15, keep_init=keep_init)
    return [
        ("pretrain", dict(overrides=mesh, batch_nums=tuple(range(100, 100 + TIMING_STEPS)),
                          val_batch=None, tf32=None)),
        ("pretrain", dict(overrides=f32, batch_nums=PARALLEL_BATCHES, val_batch=13, keep_init=keep_init,
                          params_after=1)),
        ("downstream", dict(overrides=f32 + ["audio_to_params.loss=combined"], **down)),
        ("downstream", dict(overrides=f32 + ["audio_to_params.loss=param_mse"], **down)),
        ("retrieval", dict(overrides=f32, batch_nums=(1, 2), n_queries=16, n_candidates=1024,
                           inner_chunk=128)),
    ]


def _close_params(ref, got, init, what, strict=True):
    """max over tensors of delta / max(4e-6, 5% (25% for 1-D) of the update)."""
    worst = 0.0
    for k, a in ref.items():
        a, b, p0 = a.double(), got[k].double(), init[k].double()
        delta = float((a - b).abs().max())
        limit = max(4e-6, (0.05 if a.dim() >= 2 else 0.25) * float((a - p0).abs().max()))
        worst = max(worst, delta / limit)
        if strict and delta > limit:
            raise AssertionError(f"{what} parameter {k}: {delta:.3e} from one process, limit {limit:.3e}")
    return worst


def _close_metrics(ref, got, what):
    import numpy as np

    for k, v in ref.items():
        a = v.numpy() if hasattr(v, "numpy") else v
        b = got[k].numpy() if hasattr(got[k], "numpy") else got[k]
        if not np.allclose(b, a, rtol=2e-4, atol=1e-5):
            raise AssertionError(f"{what} metric {k}: {b} vs one process {a}")


def _grad_gap(ref, got):
    """(norm ratio, ||got - ref|| / ||ref|| over all tensors, (worst tensor's
    ||got - ref|| / (||ref|| + 1e-3 of the largest tensor norm), its name)). The
    floor leaves out the biases that feed a BatchNorm, whose gradient is zero in
    exact arithmetic and rounding noise in any run."""
    import torch

    norm = lambda d: float(torch.sqrt(sum(torch.sum(v.double() ** 2) for v in d.values())))
    diff = {k: got[k].double() - ref[k].double() for k in ref}
    floor = 1e-3 * max(float(v.norm()) for v in ref.values())
    worst = max((float(diff[k].norm()) / (float(ref[k].norm()) + floor), k) for k in ref)
    return norm(got) / norm(ref), norm(diff) / norm(ref), worst


def _check_world(name, ref, ranks, model):
    """Hold one world's runs against the plain process's, in the order of RUNS;
    print its figures. The combined step's update is not held to rounding: see
    the conditioning probe in phase_parallel."""
    import numpy as np
    import torch

    _, pre, comb, mse, ret = ref
    for what, i in (("pretrain", 1), ("downstream", 2)):
        for r in ranks:
            got, want, rows = r[i]["kernels"], ref[i]["kernels"], slice(*r[i]["rows"])
            same = {k: bool(torch.equal(got[k], want[k][rows])) for k in ("audio", "d_routed", "d_scalars")}
            if not all(same.values()):
                raise AssertionError(f"{name} rank {r[i]['rank']} {what} rows {r[i]['rows']}: "
                                     f"bit-identical to one process: {same}")
    log(f"[parallel] {name}: every rank's K1 audio and K2 d_routed/d_scalars rows bit-identical "
        f"to the one-process rows (pretrain batch {PARALLEL_BATCHES[0]}, downstream batch 14)")
    for r in ranks:
        label = f"{name} rank {r[1]['rank']}"
        for step, (a, b) in enumerate(zip(pre["metrics"], r[1]["metrics"])):
            _close_metrics(a, b, f"{label} pretrain step {step}")
        _close_metrics(pre["val"], r[1]["val"], f"{label} val")
        for run, got in (("combined", r[2]), ("param_mse", r[3])):
            _close_metrics(ref[RUNS.index(run)]["metrics"], got["metrics"], f"{label} {run}")
            _close_metrics(ref[RUNS.index(run)]["test_init"], got["test_init"], f"{label} {run} test before")
        _close_metrics(mse["test"], r[3]["test"], f"{label} param_mse test after the step")
        if not (np.allclose(r[4]["best_dist"], ret["best_dist"], rtol=1e-4, atol=1e-5)
                and np.allclose(r[4]["best_params"], ret["best_params"], rtol=1e-5, atol=1e-6)):
            raise AssertionError(f"{label}: other retrieved candidates")
        for i in (1, 2, 3):  # the replica on data index 0 holds the same shard
            if r[i]["digest"] != ranks[r[i]["rank"] % model][i]["digest"]:
                raise AssertionError(f"{label} {RUNS[i]}: parameters differ from its replica")
    figures = {}
    for i in (1, 3):
        ratio, rel, worst = _grad_gap(ref[i]["grads"], ranks[0][i]["grads"])
        if abs(ratio - 1.0) > 1e-2 or worst[0] > 0.05:
            raise AssertionError(f"{name} {RUNS[i]} gradient: norm ratio {ratio}, worst tensor {worst}")
        figures[RUNS[i]] = (ratio, rel, _close_params(ref[i]["params"], ranks[0][i]["params"], ref[i]["init"],
                                                      f"{name} {RUNS[i]}"))
    ratio, rel, _ = _grad_gap(comb["grads"], ranks[0][2]["grads"])
    if not 2 / 3 < ratio < 3 / 2:  # a gradient counted W times, or 1/W, is outside
        raise AssertionError(f"{name} combined gradient norm ratio {ratio}")
    figures["combined"] = (ratio, rel, _close_params(comb["params"], ranks[0][2]["params"], comb["init"],
                                                     f"{name} combined", strict=False))
    same_audio = all(bool(torch.equal(r[4]["best_audio"], ret["best_audio"])) for r in ranks)
    log(f"[parallel] {name}: metrics within rtol 2e-4 / atol 1e-5 on every rank (train steps, val, both "
        f"downstream test steps before the update, param_mse's after it); the same retrieved candidates "
        f"(audio bit-identical: {same_audio}); gradient norm ratio, relative difference and parameters' "
        f"worst share of their bound: " + "; ".join(f"{k} {v[0]:.6f}, {v[1]:.3e}, {v[2]:.3f}"
                                                   for k, v in figures.items()))
    for r in ranks:
        pre_r, comb_r, ret_r = r[1], r[2], r[4]
        log(f"[parallel] {name} rank {pre_r['rank']} ({pre_r['backend']}, rows {pre_r['rows']}): launches "
            f"pretrain {pre_r['launches']} combined {comb_r['launches']} retrieval {ret_r['launches']}; "
            f"all_reduce per step: pretrain {pre_r['all_reduce_per_step']['calls']:.0f} calls "
            f"{pre_r['all_reduce_per_step']['bytes'] / 1e6:.2f} MB, combined "
            f"{comb_r['all_reduce_per_step']['calls']:.0f} calls {comb_r['all_reduce_per_step']['bytes'] / 1e6:.2f} MB, "
            f"retrieval per batch {ret_r['all_reduce_per_step']['calls']:.0f} calls "
            f"{ret_r['all_reduce_per_step']['bytes'] / 1e6:.2f} MB; peak memory pretrain "
            f"{pre_r['peak_bytes'] / 1e9:.2f} GB combined {comb_r['peak_bytes'] / 1e9:.2f} GB retrieval "
            f"{ret_r['peak_bytes'] / 1e9:.2f} GB; f32 step times pretrain "
            f"{[round(t * 1e3, 1) for t in pre_r['step_s']]} ms combined {comb_r['step_s'][0] * 1e3:.1f} ms "
            f"retrieval {[round(t * 1e3, 1) for t in ret_r['step_s']]} ms")
        for run, need in ((pre_r, ("render_fwd",)), (comb_r, ("render_fwd", "render_bwd")),
                          (ret_r, ("render_fwd",))):
            if any(run["launches"][k] < 1 for k in need):
                raise AssertionError(f"{name} rank {run['rank']}: a kernel of the path was not launched: "
                                     f"{run['launches']}")


def _release_cuda() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_parallel(worlds=PARALLEL_WORLDS) -> dict:
    """The multi-rank path; see the module docstring, item 10. ``worlds``: (name,
    data, model, backend) per world; rank r runs on cuda:r % device_count."""
    import os
    import statistics as st

    from inverse_audio_synthesis_tpu_torch.parallel import jobs
    from inverse_audio_synthesis_tpu_torch.parallel.launch import spawn_world

    t0 = time.time()
    plain = [getattr(jobs, n)(**kw) for n, kw in _parallel_calls([], keep_init=True)]
    timing_plain = st.median(plain[0]["step_s"][2:]) * 1e3
    # the combined step's conditioning: the same step with each value of the
    # frozen representation one float32 ulp away
    comb = _parallel_calls([], keep_init=True)[2][1]
    probe = jobs.downstream(**comb, perturb_repr=True)
    probe_ratio, probe_rel, _ = _grad_gap(plain[2]["grads"], probe["grads"])
    probe_params = _close_params(plain[2]["params"], probe["params"], plain[2]["init"], "probe", strict=False)
    log(f"[parallel] one process, no process group: pretraining f32 loss {plain[1]['metrics'][-1]['vicreg/train/loss']:.6f}, "
        f"combined loss {plain[2]['metrics']['audio_to_params/train/loss']:.6f}, retrieval best distances mean "
        f"{float(plain[4]['best_dist'].mean()):.5f}; in {time.time() - t0:.1f} s")
    log(f"[parallel] the combined step's conditioning, one process: the frozen representation moved by one "
        f"float32 ulp moves the gradient by {probe_rel:.3e} of its norm (norm ratio {probe_ratio:.6f}) and "
        f"the parameters by {probe_params:.3f} of their bound (5% of the update, 25% for 1-D); the "
        f"grad-through-synth term amplifies rounding, so that step's update is compared by its norm only")
    del plain[0]["params"], plain[0]["grads"], probe
    _release_cuda()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")  # the ranks' allocators
    out = {"worlds": {}, "plain_timing_ms": timing_plain, "conditioning_grad_rel": probe_rel,
           "conditioning_norm_ratio": probe_ratio}
    for name, data, model, backend in worlds:
        t0 = time.time()
        mesh = [f"mesh.data={data}", f"mesh.model={model}"]
        ranks = spawn_world(data * model, jobs.run_all, (_parallel_calls(mesh),), backend=backend, timeout=900)
        backends = sorted({r[1]["backend"] for r in ranks})
        log(f"[parallel] {name}: mesh data={data} model={model}, backend {backends}, ran in "
            f"{time.time() - t0:.1f} s")
        if backends != [backend]:
            raise AssertionError(f"{name} ran on {backends}, not {backend}")
        _check_world(name, plain, ranks, model)
        timing = st.median(ranks[0][0]["step_s"][2:]) * 1e3
        out["worlds"][name] = {
            "launches_per_rank": [{"pretrain": r[1]["launches"], "downstream_combined": r[2]["launches"],
                                   "retrieval": r[4]["launches"]} for r in ranks],
            "all_reduce_per_step": ranks[0][1]["all_reduce_per_step"],
            "bf16_pretrain_step_ms": timing,
        }
        if data * model == 1:
            out["nccl_timing_ms"] = timing
            log(f"[parallel] the distributed path's own cost, bf16 default config, pretraining batch 16, "
                f"median of steps 3-{TIMING_STEPS}: one {backend} rank {timing:.1f} ms a step, no process "
                f"group {timing_plain:.1f} ms ({timing / timing_plain:.3f}x)")
        elif backend == "gloo":
            log(f"[parallel] {name}: bf16 pretraining step {timing:.1f} ms (ranks share one card over gloo, "
                f"which stages every all_reduce through the host: not a scaling figure)")
        else:
            log(f"[parallel] {name}: bf16 pretraining step {timing:.1f} ms, batch 16 over {data} data ranks; "
                f"one process on one card {timing_plain:.1f} ms")
        del ranks
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_run = time.time()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from inverse_audio_synthesis_tpu_torch.ops import build
    from inverse_audio_synthesis_tpu_torch.ops import render as R

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}; torch {torch.__version__} CUDA {torch.version.cuda}")
    t0 = time.time()
    libs = build.build_libraries()
    log(f"[build] {', '.join(p.name for p in libs.values())} in {time.time() - t0:.1f} s")
    run = R.run_length(100)  # the 4 s voices' ratio, 176400 / 1764
    resources = {}
    for name in ("render_fwd", "render_bwd"):
        lib = libs[name]
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
    golden = phase_golden()
    render_bwd = phase_render_bwd()
    lars = phase_lars()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        ckpt_dir = Path(tmp) / "vicreg"
        train = phase_train(ckpt_dir)
        dispatch = phase_dispatch()
        downstream = phase_downstream(ckpt_dir, train["probe"])
        retrieval = phase_retrieval(ckpt_dir, render[128]["ms"])
        phase_hear(ckpt_dir)
        phase_export(ckpt_dir)
    _release_cuda()
    parallel = phase_parallel()

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
            "launches_by_path": {"golden_probes": golden["launches"][name],
                                 "vicreg_pretrain": train["launches"][name],
                                 "vicreg_pretrain_graph": dispatch["graph_launches"][name],
                                 "downstream_combined": downstream["launches"][name],
                                 "retrieval": retrieval["launches"][name]},
            "launches_per_rank": {world: [{path: r[path][name] for path in r} for r in w["launches_per_rank"]]
                                  for world, w in parallel["worlds"].items()},
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
    kernels[0]["pretrain_step_ms_by_steps_per_dispatch"] = {
        str(k): {key: v[key] for key in ("step_ms", "host_launch_calls_per_step", "device_idle_share", "peak_gb")}
        for k, v in dispatch["timing"].items()}
    kernels.append({
        "name": "lars", "route": "cuda", "source": "inverse_audio_synthesis_tpu_torch/csrc/lars.cu",
        "replaces": None, "launches_by_path": {"vicreg_pretrain": train["lars_launches"]},
        "resources": {"ptxas": lars["ptxas"], "blocks_per_sm": lars["blocks_per_sm"]},
        "by_model": {m: {**lars[m], "share_of_bound": lars[m]["bound_ms"] / lars[m]["ms"]} for m in LARS_MODELS},
    })
    kernels[1]["downstream_step_ms"] = downstream["step_ms"]
    kernels[0]["golden_probes"] = golden["probes"]
    kernels[0]["retrieval"] = {k: retrieval[k] for k in ("batch_ms", "candidates_per_s", "k1_share", "noise_ms")}
    log(f"[run] wall time {time.time() - t_run:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
