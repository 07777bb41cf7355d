"""Joining a process group, and spawning a world of ranks on one machine.

- ``init_from_env(cfg)``: the CLIs' entry. Under ``torchrun`` (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` set) the process
  joins the group; without those variables nothing changes. The device is
  ``cuda:LOCAL_RANK % device_count``, or the CPU with ``platform=cpu``. The
  backend is NCCL when every local rank has a card of its own and gloo when ranks
  share one (NCCL refuses two ranks on one device) or run on the CPU. The choice
  is logged and returned.
- ``spawn_world(world, target, args, ...)``: run ``target(*args)`` on each of
  ``world`` ranks, each a process started with ``spawn`` (safe after the parent
  touched CUDA), joined through a file rendezvous in a fresh directory (no
  port, so concurrent worlds cannot collide). Returns each rank's result; a
  rank that fails fails the call. ``target`` must be importable by path: the
  runs in ``parallel/jobs.py`` are.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import multiprocessing.connection as mp_connection
import os
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def choose_backend(platform: Optional[str], local_world: int) -> str:
    """gloo on the CPU or when local ranks share a card, NCCL otherwise."""
    if platform == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass platform=cpu to run the port on the CPU")
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def _bind_device(platform: Optional[str], local_rank: int) -> None:
    if platform == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(local_rank % torch.cuda.device_count())


def init_from_env(cfg) -> Optional[str]:
    """Join the process group ``torchrun``'s variables describe; returns the
    backend, or None (one rank, no group) when they are absent."""
    if not all(k in os.environ for k in _ENV):
        return None
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local_rank = int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    platform = cfg.get("platform")
    backend = choose_backend(platform, local_world)
    _bind_device(platform, local_rank)
    dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank)
    msg = f"rank {rank} of {world}: backend {backend}"
    log.info(msg)
    if rank == 0:
        print(msg, flush=True)
    return backend


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def finish() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank: int, world: int, init_file: str, backend: str, platform: Optional[str],
               target: Callable, args: Sequence[Any], out: str) -> None:
    _bind_device(platform, rank)
    dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=world, rank=rank)
    try:
        result = target(*args)
        torch.save(result, f"{out}.tmp")
        os.replace(f"{out}.tmp", out)
    except BaseException:
        Path(f"{out}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn_world(world: int, target: Callable, args: Sequence[Any] = (), platform: Optional[str] = None,
                backend: Optional[str] = None, timeout: float = 900.0) -> List[Any]:
    """``target(*args)`` on ``world`` spawned ranks -> the ranks' results, in rank
    order. ``platform="cpu"`` runs gloo on the CPU; otherwise every rank binds
    ``cuda:rank % device_count`` with ``choose_backend``'s backend unless
    ``backend`` is given."""
    backend = backend or choose_backend(platform, world)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="world_") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        procs = [
            ctx.Process(target=_rank_main, args=(r, world, os.path.join(tmp, "rendezvous"), backend,
                                                 platform, target, tuple(args), outs[r]))
            for r in range(world)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:  # until all end, one fails (the others would wait in a collective) or time is up
            while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                mp_connection.wait([p.sentinel for p in procs if p.is_alive()], timeout=1.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0 or not os.path.exists(outs[r])]
        if failed:
            errors = [Path(f"{outs[r]}.err").read_text() for r in failed if os.path.exists(f"{outs[r]}.err")]
            raise RuntimeError(
                f"ranks {failed} of a {world}-rank {backend} world failed (exit codes "
                f"{[procs[r].exitcode for r in failed]}):\n" + "\n".join(errors)[-6000:]
            )
        return [torch.load(o, map_location="cpu", weights_only=False) for o in outs]
