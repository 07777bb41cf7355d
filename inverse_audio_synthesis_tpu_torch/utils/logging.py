"""Metrics logging with a wandb-shaped surface.

The reference logs scalars/audio/config to wandb (reference: runsetup.py:50-66,
vicreg_audio_params.py:117-120, audio_to_params.py:260-273). wandb is not installed in
this environment, so the default sink is a local JSONL file (one object per log call)
plus WAV files for audio; if wandb IS importable and ``cfg.log == "wand"`` (the
reference's literal opt-in string, reference: conf/config.yaml:14-15), it is used too.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from inverse_audio_synthesis_tpu_torch.utils.audio_io import write_wav

try:  # pragma: no cover - wandb not installed in this environment
    import wandb as _wandb
except Exception:  # pragma: no cover
    _wandb = None


class MetricsLogger:
    """JSONL metrics logger; drop-in for the subset of wandb the pipeline uses."""

    def __init__(
        self,
        run_dir: str = "runs",
        project: str = "vicreg-synth1b1-pqmfs",
        config: Optional[Dict[str, Any]] = None,
        use_wandb: bool = False,
        run_name: Optional[str] = None,
    ):
        stamp = run_name or time.strftime("%Y%m%d-%H%M%S")
        self.dir = Path(run_dir) / stamp
        self.dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.dir / "metrics.jsonl", "a")
        self._step = 0
        if config is not None:
            with open(self.dir / "config.json", "w") as f:
                json.dump(config, f, indent=2, default=str)
        self._wandb_run = None
        if use_wandb and _wandb is not None:  # pragma: no cover
            self._wandb_run = _wandb.init(project=project, config=config)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        step = self._step if step is None else step
        self._step = step + 1
        record = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
                v = float(v.item())
            record[k] = v
        self._f.write(json.dumps(record, default=str) + "\n")
        self._f.flush()
        if self._wandb_run is not None:  # pragma: no cover
            self._wandb_run.log(metrics, step=step)

    def log_audio(
        self, name: str, samples: np.ndarray, sample_rate: int, step: Optional[int] = None
    ) -> Path:
        """Log an audio clip (reference logs wandb.Audio, audio_to_params.py:260-273)."""
        audio_dir = self.dir / "audio"
        audio_dir.mkdir(exist_ok=True)
        safe = name.replace("/", "_")
        path = audio_dir / f"{safe}-{step if step is not None else self._step}.wav"
        write_wav(path, np.asarray(samples), sample_rate)
        self.log({f"audio/{name}": str(path)}, step=step)
        return path

    def finish(self) -> None:
        self._f.close()
        if self._wandb_run is not None:  # pragma: no cover
            self._wandb_run.finish()
