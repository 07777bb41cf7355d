#!/usr/bin/env python3
"""The multi-rank phase of chip_smoke.py on several cards, one rank per card over NCCL.

    python3 tools/multirank_cards.py

Needs two or more CUDA cards on one host (an even count). Builds both render
kernels, makes chip_smoke.py's plain one-process runs on card 0, then the same
runs on every card as (cards x 1) and (cards/2 x 2) meshes, one NCCL rank per
card, and holds each world against the plain runs with chip_smoke.py's checks
(rows bit for bit, metrics, gradients, parameters, retrieved candidates). Prints
the cards' names and power limits, chip_smoke.py's per-world lines, and one JSON
line of the figures. Exits non-zero on any failure.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2 or n % 2:
        print(f"multirank_cards: needs an even number of CUDA cards >= 2, found {n}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from inverse_audio_synthesis_tpu_torch.ops import render as R

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    chip_smoke.log(f"[device] {n} cards: {'; '.join(smi.splitlines())}; torch {torch.__version__}")
    t0 = time.time()
    R.build_render_libraries()
    chip_smoke.log(f"[build] both kernels in {time.time() - t0:.1f} s")
    worlds = ((f"{n} ranks ({n}x1), NCCL, one card each", n, 1, "nccl"),
              (f"{n} ranks ({n // 2}x2), NCCL, one card each", n // 2, 2, "nccl"))
    out = chip_smoke.phase_parallel(worlds)
    print(json.dumps({"cards": n, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
