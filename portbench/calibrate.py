#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control] [--fault <name>]

For each seed, in one process: builds the cell's job as a run's set-up does
(weights from the seed, the first steps through the program's own loop), warms
up, then with the program freed runs the float32 reference and prints the
numbers a run compares. With ``--control`` it also prints the control's
numbers: the reference computed in float8 (e4m3) in the program's place,
compared in the same way with the float32 reference. With ``--fault`` the
program runs with that fault of ``faults.py`` planted. The lower reading of a
limit is the largest the program gives over a dozen seeds or more; the upper,
the smallest the control (or a fault) gives. Prints one JSON line per seed and
side.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from portbench.core import env  # noqa: E402

env.setup()

from portbench.faults import FAULTS  # noqa: E402


def _detail(outputs, reference) -> dict:
    """Where the numbers come from: each step's loss gap, and the leaves with the
    largest norm gaps with the median leaf's gap."""
    if "loss" not in outputs:
        return {}
    out = {k: [outputs.get(k), reference[k]] for k in reference if isinstance(reference[k], list)}
    for key in ("grad", "change"):
        out[key] = {n: [outputs[key][n], reference[key][n]] for n in reference[key]}
    return out


def readings(workload: str, seeds, control: bool, device, overrides=None, detail=False, fault=None) -> list:
    import torch

    from portbench.core import spec

    cell = spec.load_cell(workload)
    if overrides:
        cell.traffic = dict(cell.traffic, overrides={**cell.traffic.get("overrides", {}), **overrides})
    module = spec.job_module(cell.traffic["job"])
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        job = module.Job(cell.config, cell.traffic, seed, device)
        job.warmup()
        job.free()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        reference = job.reference()
        t2 = time.perf_counter()
        rows = {"workload": workload, "seed": seed, "side": f"fault {fault}" if fault else "program",
                "checks": job.compare(job.program, reference, None).as_dict(),
                "setup_s": t1 - t0, "reference_s": t2 - t1}
        if detail:
            rows["detail"] = _detail(job.program, reference)
        print(json.dumps(rows), flush=True)
        out.append(rows)
        if control:
            low = job.reference("fp8")
            rows = {"workload": workload, "seed": seed, "side": "control",
                    "checks": job.compare(low, reference, None).as_dict()}
            if detail:
                rows["detail"] = _detail(low, reference)
            print(json.dumps(rows), flush=True)
            out.append(rows)
        del job
        gc.collect()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--detail", action="store_true", help="each step's loss gap and the largest leaf gaps")
    ap.add_argument("--fault", choices=sorted(FAULTS), help="plant this fault in the program")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="a configuration override (JSON value), e.g. precision=\"f32\": another witness")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    overrides = {k: json.loads(v) for k, v in (kv.split("=", 1) for kv in args.set)}
    seeds = [int(s) for s in args.seeds.split(",")]
    with FAULTS[args.fault]() if args.fault else contextlib.nullcontext():
        readings(args.workload, seeds, args.control, torch.device("cuda", 0), overrides, args.detail, args.fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
