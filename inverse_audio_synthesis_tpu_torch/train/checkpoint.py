"""Checkpoints of a train state, with the JAX package's cadence and commit semantics.

Counterpart of the JAX package's ``train/checkpoint.py``, in the port's own format:
``<dir>/step_<12 digits>/state.pt``, a ``torch.save`` of ``{"step", "model"
(state_dict), "optimizer" (state_dict)}``, all on the host.

- Cadence saves (``maybe_save``) are asynchronous: ``save`` copies the state to
  the host before it returns (so the next step may update the device tensors in
  place), then a background thread writes it.
- The ``last`` alias is committed only after the write finishes, by an atomic
  rename, and only then are checkpoints beyond the newest ``keep`` (3) removed: a
  crash mid-write never leaves ``last`` pointing at a torn checkpoint. A step
  directory appears only whole (written under a temporary name, then renamed).
- Restores, and the final and preemption saves, block. A failed background write
  is raised at the next ``wait``/``save``.
- Under a distributed mesh (``parallel/mesh.py``) every rank calls ``save`` (the
  model group gathers each split tensor, of the model and of the optimizer's
  per-parameter state) and rank 0 alone writes the full,
  unsharded state, in the same format: a checkpoint does not depend on the mesh
  that wrote it. ``latest_step`` waits, behind a barrier, for rank 0's write to
  be committed; ``restore`` loads the full state on every rank, which keeps its
  shard.
"""

from __future__ import annotations

import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from inverse_audio_synthesis_tpu_torch.parallel.collectives import barrier
from inverse_audio_synthesis_tpu_torch.parallel.mesh import Mesh, full_state_dict, gather_state, local_state_dict


def _host_copy(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in state_dict.items()}


class CheckpointManager:
    def __init__(self, directory: str, every_n_steps: int = 10000, keep: int = 3,
                 mesh: Optional[Mesh] = None):
        self.dir = Path(directory).resolve()
        self.mesh = mesh or Mesh()
        self.writer = self.mesh.rank == 0
        if self.writer:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.every_n_steps = every_n_steps
        self.keep = keep
        self._waiter: Optional[threading.Thread] = None  # the write in flight
        self._async_error: Optional[Exception] = None  # raised at the next wait()

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:012d}"

    def maybe_save(self, state, step: int) -> bool:
        if self.every_n_steps and step % self.every_n_steps == 0 and step > 0:
            self.save(state, step, blocking=False)
            return True
        return False

    def save(self, state, step: int, blocking: bool = True) -> Path:
        """Save ``state`` (``.step``, ``.model``, ``.optimizer``) as ``step``."""
        self.wait()  # at most one write in flight
        path = self._step_dir(step)
        if not self.writer:
            if self.mesh.tensor_parallel:  # its part in the gathers
                full_state_dict(state.model, self.mesh)
                gather_state(state.optimizer.state_dict(), self.mesh)
            return path
        payload = {
            "step": int(state.step),
            "model": full_state_dict(state.model, self.mesh),
            "optimizer": gather_state(state.optimizer.state_dict(), self.mesh),
        }
        if blocking:
            self._write_and_commit(payload, path)
        else:
            self._waiter = threading.Thread(
                target=self._finalize_async, args=(payload, path), daemon=False
            )
            self._waiter.start()
        return path

    def _write_and_commit(self, payload: Dict[str, Any], path: Path) -> None:
        tmp = path.with_name(f"{path.name}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        torch.save(payload, tmp / "state.pt")
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        self._commit(path)

    def _finalize_async(self, payload, path: Path) -> None:
        try:
            self._write_and_commit(payload, path)
        except Exception as e:  # surfaced by the next wait()/save()
            self._async_error = e

    def wait(self) -> None:
        """Block until the write in flight is on disk and committed; raise if it failed."""
        if self._waiter is not None:
            self._waiter.join()
            self._waiter = None
        if self._async_error is not None:
            err, self._async_error = self._async_error, None
            raise RuntimeError("async checkpoint save failed; `last` was not committed") from err

    def _commit(self, path: Path) -> None:
        tmp = self.dir / "last.tmp"
        tmp.write_text(path.name)
        os.replace(tmp, self.dir / "last")  # save_last
        self._gc()

    def _steps_on_disk(self):
        steps = []
        if not self.dir.is_dir():
            return steps
        for d in self.dir.glob("step_*"):
            if d.is_dir() and d.name.split("_")[1].isdigit():  # skip writes in flight
                steps.append(int(d.name.split("_")[1]))
        return sorted(steps)

    def _gc(self) -> None:
        steps = self._steps_on_disk()
        for old in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        self.wait()
        barrier(self.mesh)  # rank 0's writes are committed
        last = self.dir / "last"
        if last.exists():
            name = last.read_text().strip()
            if (self.dir / name).exists():
                return int(name.split("_")[1])
        steps = self._steps_on_disk()  # no alias: accept whole step directories only
        return steps[-1] if steps else None

    def restore(self, state):
        """Load the latest checkpoint into ``state`` in place (model and optimizer
        tensors keep their devices; this rank's shard of each split tensor) and
        return it. If any part fails to load,
        ``state`` is put back as it was before the error propagates, as the JAX
        package's functional restore leaves the fresh state intact."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.dir}")
        payload = torch.load(self._step_dir(step) / "state.pt", map_location="cpu",
                             weights_only=True)
        model_before = _host_copy(state.model.state_dict())
        optimizer_before = _host_copy(state.optimizer.state_dict())
        try:
            state.model.load_state_dict(local_state_dict(payload["model"], self.mesh))
            state.optimizer.load_state_dict(local_state_dict(payload["optimizer"], self.mesh))
            state.step = int(payload["step"])
        except Exception:
            state.model.load_state_dict(model_before)
            state.optimizer.load_state_dict(optimizer_before)
            raise
        return state
