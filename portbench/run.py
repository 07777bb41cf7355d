#!/usr/bin/env python3
"""One benchmark run of the PyTorch port on CUDA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from BENCHMARK.json and the files it names (``core/spec.py``),
builds the cell's job (``jobs/<job>.py``) from the seed: inputs, weights and the
first steps that the reference follows; warms up every shape the window uses;
then lets the job work for ``--seconds`` seconds (``Job.run_for``: whole steps,
the last one finished). With ``--trace 0`` it reports the cell's end-to-end
metrics over that window. With ``--trace 1`` the same work runs on without a
break: the first half of the window unprofiled, then ``profile_seconds`` (the
traffic file) more under the profiler (``core/trace.Split``); it reports the
per-layer metrics, the device's busy and window seconds and a breakdown. Each metric is read by
``metrics/<name>.py``; a reader that finds nothing returns None and the metric
is left out. After the window, with the peak memory read and the program's
state freed, the plain reference decides ``correct``; every number compared
is printed beside its limit as the last lines of standard error and under
``checks``, the last key of the result, the last line of standard output.

Exits non-zero with no result when no CUDA card is there, when the cell asks
for more cards than there are, or when JAX or the JAX package was loaded.
Build and kernel caches stay inside the checkout, under ``build/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from portbench.core import env  # noqa: E402

env.setup()


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(job, seconds: float, device):
    """The job's work for ``seconds`` -> (unit records, elapsed seconds, synchronised)."""
    _sync(device)
    t0 = time.perf_counter()
    records = job.run_for(seconds)
    _sync(device)
    return records, time.perf_counter() - t0


def read_metrics(metrics, ctx) -> dict:
    from portbench.core import spec

    out = {}
    for m in metrics:
        value = spec.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.core import spec, trace
    from portbench.core.check import Checks

    cell = spec.load_cell(args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("portbench: no CUDA device; the benchmark runs only on the card", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"portbench: {args.workload} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    cuda = device.type == "cuda"

    stages = {"imports": time.perf_counter() - T_START}
    job = spec.job_module(cell.traffic["job"]).Job(cell.config, cell.traffic, args.seed, device)
    stages["job"] = time.perf_counter() - T_START - sum(stages.values())
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    job.warmup()
    _sync(device)
    setup_s = time.perf_counter() - T_START
    stages["warmup"] = setup_s - sum(stages.values())
    print("portbench: set-up seconds " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()), file=sys.stderr)

    summary, records_profiled = None, []
    if args.trace:
        profile_s = float(cell.traffic["profile_seconds"])
        split = trace.Split(args.seconds / 2, profile_s, lambda: _sync(device))
        split.start()
        job.run_for(args.seconds + profile_s, on_unit=split.unit)
        split.stop()
        records, elapsed = split.before, split.before_seconds
        summary, records_profiled = split.summary, split.profiled
    else:
        records, elapsed = _window(job, args.seconds, device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    loaded = env.forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {loaded}: nothing it runs may import JAX or the JAX package",
              file=sys.stderr)
        return 4

    ctx = {
        "window": {"seconds": elapsed, "units": records},
        "setup_s": setup_s,
        "peak_bytes": peak,
        "trace": summary,
        "config": cell.config,
    }
    if summary is not None:
        ctx["profiled"] = records_profiled
        ctx["launches"] = job.render_launches(records_profiled)
        ctx["model_flops"] = job.model_flops(records)
        metrics = read_metrics(cell.per_layer, ctx)
    else:
        metrics = read_metrics(cell.end_to_end, ctx)
    attempted = sum(r["attempted"] for r in records + records_profiled)
    failed = job.failed()

    job.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    try:
        checks = job.compare(job.program, job.reference(), cell.limits["limits"])
    except Exception:  # a reference that cannot judge the answers leaves the run not correct
        checks = Checks(cell.limits["limits"])
        traceback.print_exc()
    if env.forbidden_modules():
        print(f"portbench: the reference loaded {env.forbidden_modules()}", file=sys.stderr)
        return 4

    result = {
        "correct": checks.correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": peak,
            "power_limit_w": power_limit_w() if cuda else None,
        },
    }
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = trace.breakdown(summary)
    result["checks"] = checks.as_dict()
    print(json.dumps(result), flush=True)
    for line in checks.lines():
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(run())
