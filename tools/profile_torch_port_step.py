#!/usr/bin/env python3
"""Where the time of one train step of the PyTorch port goes, on one CUDA card.

    python3 tools/profile_torch_port_step.py [--task vicreg|downstream|retrieval] [--steps N]
        [--nccl-rank] [--steps-per-dispatch K] [overrides ...]

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
    embed, cdist, update: ``eval/retrieval.py``);
  - the host (CPU) self time per step of the operators that take the most.
``--nccl-rank`` runs the task as the one rank of an NCCL process group, so that
the step takes the distributed code path with its collectives as real calls.
``--steps-per-dispatch K`` (pretraining) drives the steps K at a time through
``train_step_multi``, which on the card replays one CUDA graph of K steps
(captured in the warm-up), and adds the host's launch calls per step, kernels
(``cudaLaunchKernel``) and graphs (``cudaGraphLaunch``), to the figures.
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


HOST_LAUNCH_CALLS = {"kernel": ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx"),
                     "graph": ("cudaGraphLaunch", "cuGraphLaunch")}


def profile_window(run, n_steps: int, unprofiled_ms: float):
    """Profile ``run()`` (which takes ``n_steps`` train steps and returns after
    the card has finished them) -> per step: device busy ms (the sum of kernel
    durations: one stream, so they do not overlap), the idle share against
    ``unprofiled_ms``, kernels run on the card, the host's launch calls by kind,
    and the profiler itself (kernel name -> [device us, count], key averages)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        prof_step_ms = (time.perf_counter() - t0) / n_steps * 1e3
    kernels = defaultdict(lambda: [0.0, 0])  # name -> [device us, launches]
    calls = dict.fromkeys(HOST_LAUNCH_CALLS, 0)
    for evt in prof.events():
        # the device-side copies of the named ranges span kernels; they are not kernels
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.name.startswith("retrieval/"):
            k = kernels[evt.name]
            k[0] += evt.time_range.elapsed_us()
            k[1] += 1
        for kind, names in HOST_LAUNCH_CALLS.items():
            if evt.device_type == torch.autograd.DeviceType.CPU and evt.name in names:
                calls[kind] += 1
    busy_ms = sum(v[0] for v in kernels.values()) / 1e3 / n_steps
    measured = busy_ms > 0
    return {
        "step_ms_profiled": prof_step_ms,
        "device_busy_ms_per_step": busy_ms if measured else "not measured",
        # kernel durations are not inflated by the profiler; its host cost is, so the
        # idle share is taken against the unprofiled step
        "device_idle_share": (1.0 - busy_ms / unprofiled_ms) if measured else "not measured",
        "kernel_launches_per_step": sum(v[1] for v in kernels.values()) / n_steps if measured else "not measured",
        "host_launch_calls_per_step": {k: v / n_steps for k, v in calls.items()},
    }, kernels, prof


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=("vicreg", "downstream", "retrieval"), default="vicreg")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--nccl-rank", action="store_true")
    ap.add_argument("--steps-per-dispatch", type=int, default=1)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args()
    k = args.steps_per_dispatch
    if k > 1 and args.task != "vicreg":
        raise SystemExit("--steps-per-dispatch is for --task vicreg")

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
    if args.nccl_rank:
        import tempfile

        import torch.distributed as dist

        torch.cuda.set_device(0)
        rendezvous = tempfile.TemporaryDirectory(prefix="profile_rendezvous_")
        dist.init_process_group("nccl", init_method=f"file://{rendezvous.name}/file", world_size=1, rank=0)
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
        def step(i):  # k train steps from batch number i (one dispatch)
            nonlocal state
            if k == 1:
                state, _ = task.train_step(state, i)
            else:
                state, _ = task.train_step_multi(state, list(range(i, i + k)))

    for i in range(3):  # with k > 1: the first runs eagerly, the second captures the graph
        step(i * k)
    torch.cuda.synchronize()

    n = args.steps  # dispatches; n * k steps
    t0 = time.perf_counter()
    for i in range(n):
        step(100 + i * k)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / (n * k) * 1e3
    print(f"{args.task} step, no sync between steps: {step_ms:.2f} ms (batch {batch}, "
          f"{k} steps a dispatch)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    step(150 * k)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def window():
        for i in range(n):
            step(200 * k + i * k)
        torch.cuda.synchronize()

    figures, kernels, prof = profile_window(window, n * k, step_ms)
    n = n * k  # per step below
    busy_ms = figures["device_busy_ms_per_step"] if figures["device_busy_ms_per_step"] != "not measured" else 0.0
    launches = figures["kernel_launches_per_step"] if busy_ms > 0 else 0.0
    prof_step_ms = figures["step_ms_profiled"]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    groups = defaultdict(float)  # group -> device ms per step
    for name, (us, _) in kernels.items():
        groups[_group(name)] += us / 1e3 / n
    # which PyTorch operators launched the device time (self time: the kernels an
    # operator launched itself, not its children's)
    ops, ranges, host = [], {}, []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CPU:
            continue
        host.append((evt.self_cpu_time_total / 1e3 / n, evt.count / n, evt.key))
        if evt.key.startswith("retrieval/"):  # a named range: its kernels' total
            ranges[evt.key] = getattr(evt, "device_time_total", 0.0) / 1e3 / n
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            ops.append((dev_us / 1e3 / n, evt.count / n, evt.key))
    ops.sort(reverse=True)
    host.sort(reverse=True)
    result = {
        "device": smi,
        "task": args.task,
        "nccl_rank": args.nccl_rank,
        "steps_per_dispatch": k,
        "batch": batch,
        "step_ms_no_sync": step_ms,
        **figures,
        "device_ms_per_step_by_group": dict(groups),
        "device_ms_per_step_by_op": {key: ms for ms, _, key in ops[:20]},
        "device_ms_per_step_by_range": ranges,
        "host_ms_per_step_by_op": {key: ms for ms, _, key in host[:12]},
        "peak_memory_gb": peak_gb,
    }
    print(f"device busy {busy_ms:.2f} ms per step ({prof_step_ms:.2f} ms profiled, "
          f"{step_ms:.2f} ms unprofiled); "
          f"{launches:.0f} kernel launches per step; host launch calls per step "
          f"{figures['host_launch_calls_per_step']}", flush=True)
    for name, (us, count) in top:
        print(f"  {us / n / 1e3:8.3f} ms/step  {count / n:6.0f} launches  {name[:110]}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  group {g}: {ms:.3f} ms/step")
    for ms, count, key in ops[:20]:
        print(f"  op {ms:8.3f} ms/step  {count:6.0f} calls  {key[:90]}")
    for key, ms in ranges.items():
        print(f"  range {key}: {ms:.3f} ms/step")
    for ms, count, key in host[:12]:
        print(f"  host {ms:8.3f} ms/step  {count:6.0f} calls  {key[:90]}")
    print(f"peak device memory of a step: {peak_gb:.2f} GB")
    print(json.dumps(result))
    if args.nccl_rank:
        dist.destroy_process_group()
        rendezvous.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
