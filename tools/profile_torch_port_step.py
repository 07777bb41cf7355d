#!/usr/bin/env python3
"""Where the time of one train step of the PyTorch port goes, on one CUDA card.

    python3 tools/profile_torch_port_step.py [--task vicreg|downstream|retrieval] [--steps N] [overrides ...]

Builds the pretraining task at the default full config (vicreg=full, bf16), or
with ``--task downstream`` the downstream task at the default downstream config
with ``audio_to_params.loss=combined`` (batch 1024, the grad-through-synth step,
random towers), or with ``--task retrieval`` the retrieval evaluator at the
default ``retrieval.*`` keys (16 queries, one step = one batch of 1024
candidates in sub-chunks of 128, random towers), takes a few warm-up steps, then
measures:
  - the step time with no host sync between steps (N steps, then one sync);
  - with torch.profiler over N steps: kernel launches per step, the device's busy
    time per step (the sum of kernel durations; one stream, so they do not
    overlap), its idle share against the unprofiled step time, the kernels that
    take the most device time, and device time per step in groups (the render
    kernels, FFTs, matrix products and convolutions, the rest);
  - the peak device memory of a step;
  - for retrieval, the device time of the evaluator's named ranges (render,
    embed, cdist, update: ``eval/retrieval.py``).
Prints one JSON line last. Needs a CUDA device; prints "not measured" for the
profiler numbers if the profiler records no device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


GROUPS = (
    ("render_bwd", ("render_bwd_kernel",)),
    ("render_fwd", ("render_kernel",)),
    ("fft", ("fft",)),
    ("matmul_conv", ("gemm", "xmma", "cutlass", "conv", "wgrad", "dgrad", "cudnn")),
)


def _group(kernel_name: str) -> str:
    low = kernel_name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=("vicreg", "downstream", "retrieval"), default="vicreg")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_port_step: no CUDA device", file=sys.stderr)
        return 2
    from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask
    from inverse_audio_synthesis_tpu_torch.utils.config import load_config

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    if args.task == "downstream":
        from inverse_audio_synthesis_tpu_torch.train.downstream import AudioToParamsTask

        cfg = load_config(overrides=["audio_to_params.loss=combined", *args.overrides])
        pretrain = VicregPretrainTask(cfg)
        task = AudioToParamsTask(cfg, pretrain, pretrain.init_state())
        del pretrain
        batch = cfg.audio_to_params.batch_size
    elif args.task == "retrieval":
        cfg = load_config(overrides=args.overrides)
        task = VicregPretrainTask(cfg)
        batch = cfg.retrieval.predict_batch_size
    else:
        cfg = load_config(overrides=args.overrides)
        task = VicregPretrainTask(cfg)
        batch = cfg.vicreg.batch_size
    state = task.init_state()
    if args.task == "retrieval":
        from inverse_audio_synthesis_tpu_torch.eval.retrieval import RetrievalEvaluator
        from inverse_audio_synthesis_tpu_torch.train.pretrain import synth_config_from_cfg

        evaluator = RetrievalEvaluator(
            lambda audio: task.project_audio(state, audio),
            synth_config_from_cfg(cfg, cfg.retrieval.test_batch_size),
            synth_config_from_cfg(cfg, batch),
            inner_chunk=cfg.retrieval.inner_chunk,
            device=task.device,
        )

        def step(i):  # one candidate batch; it ends by reading the mask on the host
            evaluator.step(i + 1)
    else:
        def step(i):
            nonlocal state
            state, _ = task.train_step(state, i)

    for i in range(3):
        step(i)
    torch.cuda.synchronize()

    n = args.steps
    t0 = time.perf_counter()
    for i in range(n):
        step(100 + i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    print(f"{args.task} step, no sync between steps: {step_ms:.2f} ms (batch {batch})", flush=True)
    torch.cuda.reset_peak_memory_stats()
    step(150)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step(200 + i)
        torch.cuda.synchronize()
        prof_step_ms = (time.perf_counter() - t0) / n * 1e3

    kernels = defaultdict(lambda: [0.0, 0])  # name -> [device us, launches]
    for evt in prof.events():
        # the device-side copies of the named ranges span kernels; they are not kernels
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.name.startswith("retrieval/"):
            k = kernels[evt.name]
            k[0] += evt.time_range.elapsed_us()
            k[1] += 1
    busy_ms = sum(v[0] for v in kernels.values()) / 1e3 / n
    launches = sum(v[1] for v in kernels.values()) / n
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    groups = defaultdict(float)  # group -> device ms per step
    for name, (us, _) in kernels.items():
        groups[_group(name)] += us / 1e3 / n
    # which PyTorch operators launched the device time (self time: the kernels an
    # operator launched itself, not its children's)
    ops, ranges = [], {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CPU:
            continue
        if evt.key.startswith("retrieval/"):  # a named range: its kernels' total
            ranges[evt.key] = getattr(evt, "device_time_total", 0.0) / 1e3 / n
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            ops.append((dev_us / 1e3 / n, evt.count / n, evt.key))
    ops.sort(reverse=True)
    result = {
        "device": smi,
        "task": args.task,
        "batch": batch,
        "step_ms_no_sync": step_ms,
        "step_ms_profiled": prof_step_ms,
        "device_busy_ms_per_step": busy_ms if busy_ms > 0 else "not measured",
        # kernel durations are not inflated by the profiler; its host cost is, so the
        # idle share is taken against the unprofiled step
        "device_idle_share": (1.0 - busy_ms / step_ms) if busy_ms > 0 else "not measured",
        "kernel_launches_per_step": launches if busy_ms > 0 else "not measured",
        "device_ms_per_step_by_group": dict(groups),
        "device_ms_per_step_by_op": {key: ms for ms, _, key in ops[:20]},
        "device_ms_per_step_by_range": ranges,
        "peak_memory_gb": peak_gb,
    }
    print(f"device busy {busy_ms:.2f} ms per step ({prof_step_ms:.2f} ms profiled, "
          f"{step_ms:.2f} ms unprofiled); "
          f"{launches:.0f} kernel launches per step", flush=True)
    for name, (us, count) in top:
        print(f"  {us / n / 1e3:8.3f} ms/step  {count / n:6.0f} launches  {name[:110]}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  group {g}: {ms:.3f} ms/step")
    for ms, count, key in ops[:20]:
        print(f"  op {ms:8.3f} ms/step  {count:6.0f} calls  {key[:90]}")
    for key, ms in ranges.items():
        print(f"  range {key}: {ms:.3f} ms/step")
    print(f"peak device memory of a step: {peak_gb:.2f} GB")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
