#!/usr/bin/env python3
"""Where the time of one VICReg train step of the PyTorch port goes, on one CUDA card.

    python3 tools/profile_torch_port_step.py [--steps N] [overrides ...]

Builds the pretraining task at the default full config (vicreg=full, bf16),
takes a few warm-up steps, then measures:
  - the step time with no host sync between steps (N steps, then one sync);
  - with torch.profiler over N steps: kernel launches per step, the device's busy
    time per step (the sum of kernel durations; one stream, so they do not
    overlap), its idle share against the unprofiled step time, and the kernels
    that take the most device time.
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


def main() -> int:
    ap = argparse.ArgumentParser()
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
    cfg = load_config(overrides=args.overrides)
    task = VicregPretrainTask(cfg)
    state = task.init_state()
    for i in range(3):
        state, _ = task.train_step(state, i)
    torch.cuda.synchronize()

    n = args.steps
    t0 = time.perf_counter()
    for i in range(n):
        state, metrics = task.train_step(state, 100 + i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    print(f"step, no sync between steps: {step_ms:.2f} ms (batch {cfg.vicreg.batch_size})", flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            state, metrics = task.train_step(state, 200 + i)
        torch.cuda.synchronize()
        prof_step_ms = (time.perf_counter() - t0) / n * 1e3

    kernels = defaultdict(lambda: [0.0, 0])  # name -> [device us, launches]
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels[evt.name]
            k[0] += evt.time_range.elapsed_us()
            k[1] += 1
    busy_ms = sum(v[0] for v in kernels.values()) / 1e3 / n
    launches = sum(v[1] for v in kernels.values()) / n
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    result = {
        "device": smi,
        "batch": cfg.vicreg.batch_size,
        "step_ms_no_sync": step_ms,
        "step_ms_profiled": prof_step_ms,
        "device_busy_ms_per_step": busy_ms if busy_ms > 0 else "not measured",
        # kernel durations are not inflated by the profiler; its host cost is, so the
        # idle share is taken against the unprofiled step
        "device_idle_share": (1.0 - busy_ms / step_ms) if busy_ms > 0 else "not measured",
        "kernel_launches_per_step": launches if busy_ms > 0 else "not measured",
        "render_us_per_step": sum(
            v[0] for name, v in kernels.items() if "render_seg_kernel" in name or "render_audio_kernel" in name
        ) / n,
    }
    print(f"device busy {busy_ms:.2f} ms per step ({prof_step_ms:.2f} ms profiled, "
          f"{step_ms:.2f} ms unprofiled); "
          f"{launches:.0f} kernel launches per step", flush=True)
    for name, (us, count) in top:
        print(f"  {us / n / 1e3:8.3f} ms/step  {count / n:6.0f} launches  {name[:110]}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
