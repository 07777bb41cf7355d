"""Nearest-neighbour retrieval over a stream of freshly synthesized candidates.

Counterpart of the JAX package's ``eval/retrieval.py``: embed a fixed set of
query sounds once, then stream candidate batches (synthesize, embed, ``cdist``
against the queries, keep each query's nearest candidate so far). The running
state (best distance, audio and parameters per query) stays on the device; the
host reads it once per candidate batch, for the improvement mask, the monotone
check and the convergence history.

What differs from the JAX evaluator, and why:

- The candidate noise buffer [candidate batch, Ta] is made once, at
  construction, and sliced per sub-chunk of ``inner_chunk`` candidates. Its rows
  are position-keyed and the same in every batch, so a sub-chunk's slice holds
  exactly the rows ``modules.noise(row_offset=sub_idx * inner_chunk)`` draws. The
  JAX evaluator draws them again for every sub-chunk to keep the 722 MB buffer
  of the full config out of a TPU's memory; here the threefry draw is plain
  int64 torch and would cost more than the towers.
- The sub-chunks run as a Python loop over the candidate batch, each rendered
  with ``render_voice_auto`` (the render kernel on the card).
- The planted-query gate floors its distance scale at ``PLANTED_FLOOR_NORM``
  times the median query-embedding norm (the JAX gate floors it at 1e-6, below
  the rounding noise of a bf16 tower).
- ``state.npz`` files do not carry over between the two packages: the weights
  fingerprint is a float32 sum over the query embeddings, which the packages
  round differently.

Under a distributed mesh (``parallel/mesh.py``) the sub-chunks of a candidate
batch are split over the data group, in contiguous blocks: each rank renders its
sub-chunks (and holds only their noise rows), embeds them and keeps, per query,
its first nearest candidate. The ranks' (distance, audio, parameters) are
gathered, and every rank applies them in rank order with
the sequential rule (strict ``<``): the result takes, per query, the lowest
global index among equal minima, as one rank does. Every rank keeps the same
state; rank 0 alone writes ``state.npz`` and the artifacts.
"""

from __future__ import annotations

import os
import signal
import zipfile
from dataclasses import replace
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from inverse_audio_synthesis_tpu_torch.parallel.collectives import agree_max, barrier, gather_rows
from inverse_audio_synthesis_tpu_torch.parallel.mesh import Mesh
from inverse_audio_synthesis_tpu_torch.synth import SynthConfig
from inverse_audio_synthesis_tpu_torch.synth.voice import (
    make_noise,
    render_voice_auto,
    sample_voice_params,
)
from inverse_audio_synthesis_tpu_torch.train.loop import PreemptionGuard

# The planted-query gate's distance scale is at least this multiple of the median
# query-embedding norm. With rtol 0.05 the gate then admits self-distances up to
# 1% of the norm, five times the bf16 towers' rounding noise (~0.2% of the norm,
# the TPU's planted self-distance): a collapsed embedding, whose inter-query
# distances are themselves rounding-sized, still passes its own self-match.
PLANTED_FLOOR_NORM = 0.2


def cdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix [Na, Nb] (torch.cdist's p=2), as the JAX
    package computes it: a^2 - 2ab + b^2, clamped at 0, then the square root."""
    a2 = torch.sum(a * a, dim=1, keepdim=True)
    b2 = torch.sum(b * b, dim=1, keepdim=True)
    sq = a2 - 2.0 * (a @ b.T) + b2.T
    return torch.sqrt(torch.clamp_min(sq, 0.0))


class RetrievalEvaluator:
    """Tracks each query's nearest neighbour over a candidate stream.

    ``embed_fn`` maps audio [B, 1, Ta] on ``device`` to embeddings [B, D]; the
    model's weights sit inside it."""

    def __init__(
        self,
        embed_fn: Callable[[torch.Tensor], torch.Tensor],
        query_synth: SynthConfig,
        candidate_synth: SynthConfig,
        query_batch_num: int = 0,
        inner_chunk: int = 128,
        device="cuda",
        mesh: Optional[Mesh] = None,
    ):
        self.embed_fn = embed_fn
        self.device = torch.device(device)
        self.mesh = mesh or Mesh()
        self.query_synth = query_synth
        self.candidate_synth = candidate_synth
        bs = candidate_synth.batch_size
        self.inner_chunk = min(inner_chunk, bs)
        if bs % self.inner_chunk:
            raise ValueError(f"inner_chunk {self.inner_chunk} must divide the candidate batch {bs}")
        if (bs // self.inner_chunk) % self.mesh.data:
            raise ValueError(f"the {bs // self.inner_chunk} sub-chunks of a candidate batch do "
                             f"not split over mesh.data={self.mesh.data}")
        self.rows = self.mesh.local_rows(bs)  # this rank's candidates: whole sub-chunks
        # what each sub-chunk renders
        self._sub_synth = replace(candidate_synth, batch_size=self.inner_chunk, reproducible=False)

        with torch.no_grad():
            self.query_params = sample_voice_params(query_batch_num, query_synth, self.device)
            # the query batch's own fixed noise rows, drawn apart from the candidate buffer
            self.query_audio = render_voice_auto(
                self.query_params, query_synth, make_noise(query_synth, self.device)
            )
            self.query_emb = embed_fn(self.query_audio[:, None, :])
        # fingerprint of the weights (the query embeddings are a function of them):
        # resuming under other weights would mix two embedding spaces. The chunking
        # and batch size are checked as separate exact fields.
        self.state_fingerprint = float(torch.sum(torch.abs(self.query_emb.float())))
        self._noise = make_noise(
            candidate_synth, self.device, self.rows.stop - self.rows.start, self.rows.start
        )
        n_q = query_synth.batch_size
        self.best_dist = torch.full((n_q,), float("inf"), device=self.device)
        self.best_audio = torch.zeros((n_q, candidate_synth.buffer_size), device=self.device)
        # the nearest neighbour's parameters: unlike embedding distances, their
        # error is comparable across checkpoints (chance floor 1/3 per parameter)
        self.best_params = torch.zeros_like(self.query_params)

    @torch.no_grad()
    def step(self, batch_num: int) -> np.ndarray:
        """Process one candidate batch; returns the per-query improvement mask."""
        k = self.inner_chunk
        params = sample_voice_params(batch_num, self.candidate_synth, self.device)[self.rows]
        query_emb = self.query_emb.float()
        before = self.best_dist
        best_dist, best_audio, best_params = self.best_dist, self.best_audio, self.best_params
        if self.mesh.distributed:  # this rank's own first minima, merged below
            best_dist = torch.full_like(best_dist, float("inf"))
        for start in range(0, params.shape[0], k):
            sub = params[start : start + k]
            # named ranges, read by tools/profile_torch_port_step.py --task retrieval
            with record_function("retrieval/render"):
                audio = render_voice_auto(sub, self._sub_synth, self._noise[start : start + k])
            with record_function("retrieval/embed"):
                emb = self.embed_fn(audio[:, None, :]).float()
            with record_function("retrieval/cdist"):
                d = cdist(query_emb, emb)  # [n_q, k]
            with record_function("retrieval/update"):
                chunk_min, chunk_arg = torch.min(d, dim=1)  # the first minimum on ties
                improved = chunk_min < best_dist
                best_dist = torch.where(improved, chunk_min, best_dist)
                best_audio = torch.where(improved[:, None], audio[chunk_arg], best_audio)
                best_params = torch.where(improved[:, None], sub[chunk_arg], best_params)
        if self.mesh.distributed:
            best_dist, best_audio, best_params = self._merge(best_dist, best_audio, best_params)
        self.best_dist, self.best_audio, self.best_params = best_dist, best_audio, best_params
        return (best_dist < before).cpu().numpy()

    def _merge(self, dist, audio, params):
        """The running state updated with every rank's first minima, in rank
        order under the sequential rule. Ranks hold contiguous blocks of the
        candidates, so rank order is global index order."""
        packed = torch.cat([dist[:, None], params, audio], dim=1)[None]
        every = gather_rows(packed, self.mesh)  # [data, n_q, 1 + nparams + Ta], exact
        best_dist, best_audio, best_params = self.best_dist, self.best_audio, self.best_params
        n_p = params.shape[1]
        for r in range(self.mesh.data):
            d, p, a = every[r, :, 0], every[r, :, 1 : 1 + n_p], every[r, :, 1 + n_p :]
            improved = d < best_dist
            best_dist = torch.where(improved, d, best_dist)
            best_audio = torch.where(improved[:, None], a, best_audio)
            best_params = torch.where(improved[:, None], p, best_params)
        return best_dist, best_audio, best_params

    @torch.no_grad()
    def planted_query_distance(self) -> Tuple[np.ndarray, np.ndarray]:
        """(self-distances [n_q], distance matrix [n_q, n_q]): the query parameters
        rendered through the candidate path (its renderer, the candidate buffer's
        noise rows 0..n_q-1, which are the query batch's rows) and embedded, against
        the stored query embeddings. The inputs are the same by construction, so
        the self-distances are ~0 unless the two paths have drifted apart (noise
        keying, renderer, embedding)."""
        n_q = self.query_params.shape[0]
        planted_synth = replace(self._sub_synth, batch_size=n_q)
        if self.rows.start == 0 and n_q <= self._noise.shape[0]:
            noise = self._noise[:n_q]
        else:
            noise = make_noise(self.candidate_synth, self.device, n_q)
        audio = render_voice_auto(self.query_params, planted_synth, noise)
        emb = self.embed_fn(audio[:, None, :])
        d = cdist(self.query_emb.float(), emb.float()).cpu().numpy()
        return np.diagonal(d).copy(), d

    def assert_planted_queries_found(self, rtol: float = 0.05) -> None:
        """Self-distances must be far below the distance scale between sounds.

        Not bit-identity: the stored query embeddings and the planted render are
        embedded at different batch sizes, and under bf16 the towers round
        differently per batch size. The scale is the median distance between
        different queries, floored at ``PLANTED_FLOOR_NORM`` times the median
        query-embedding norm; a real divergence puts the planted candidates at
        the distance between different sounds."""
        diag, d = self.planted_query_distance()
        off = d[~np.eye(d.shape[0], dtype=bool)]
        median_off = float(np.median(off)) if off.size else 0.0
        norms = torch.linalg.vector_norm(self.query_emb.float(), dim=1).cpu().numpy()
        floor = PLANTED_FLOOR_NORM * float(np.median(norms))
        scale = max(median_off, floor)
        if not (diag <= rtol * scale).all():
            raise AssertionError(
                f"planted-query check failed: self-distances {diag} not << the distance "
                f"scale {scale:.3g} (median between queries {median_off:.3g}, floor "
                f"{floor:.3g}): the query and candidate pipelines have diverged; "
                "retrieval distances are not trustworthy"
            )

    def _load_state(self, state_file: Path):
        """Load the running state from ``state_file`` when it was written under
        this run's weights, shapes and chunking and return (history, start batch);
        else leave the state as it is and return None."""
        try:
            with np.load(state_file) as f:
                z = dict(f)
        except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:
            # e.g. a kill tore the write: a torn state file must not make every
            # supervised resume crash; start afresh instead
            print(f"retrieval: ignoring {state_file} (unreadable: {e!r})")
            return None
        same_run = (
            z["best_audio"].shape == tuple(self.best_audio.shape)
            and "best_params" in z
            and np.isclose(float(z.get("fingerprint", np.nan)), self.state_fingerprint, rtol=1e-6)
            and int(z.get("inner_chunk", -1)) == self.inner_chunk
            and int(z.get("candidate_bs", -1)) == self.candidate_synth.batch_size
        )
        if not same_run:
            print(f"retrieval: ignoring {state_file} (different model, shape, or chunking)")
            return None
        self.best_dist = torch.from_numpy(z["best_dist"]).to(self.device)
        self.best_audio = torch.from_numpy(z["best_audio"]).to(self.device)
        self.best_params = torch.from_numpy(z["best_params"]).to(self.device)
        start = int(z["batches_done"])
        print(f"retrieval: resuming from {state_file} at batch {start}")
        return [row.copy() for row in z["history"]], start

    def _save_state(self, state_file: Path, history: list, batches_done: int) -> None:
        state_file.parent.mkdir(parents=True, exist_ok=True)
        tmp = state_file.with_name("state.tmp.npz")  # then an atomic rename
        np.savez(
            tmp,
            best_dist=self.best_dist.cpu().numpy(),
            best_audio=self.best_audio.cpu().numpy(),
            best_params=self.best_params.cpu().numpy(),
            history=np.stack(history),
            batches_done=batches_done,
            fingerprint=self.state_fingerprint,
            inner_chunk=self.inner_chunk,
            candidate_bs=self.candidate_synth.batch_size,
        )
        os.replace(tmp, state_file)

    def _log_improvements(self, logger, improved: np.ndarray, cur: np.ndarray, sample_rate: int, step: int):
        """(query, half a second of silence, match) clips for the improved queries."""
        idx = np.nonzero(improved)[0]
        queries = self.query_audio[idx].cpu().numpy()
        matches = self.best_audio[idx].cpu().numpy()
        silence = np.zeros(sample_rate // 2, np.float32)
        for q, query, match in zip(idx, queries, matches):
            clip = np.concatenate([query, silence, match])
            logger.log_audio(f"retrieval/query{q}-dist{cur[q]:.3f}", clip, sample_rate, step=step)

    def run(
        self,
        n_batches: int,
        logger=None,
        sample_rate: int = 44100,
        log_every_improvement: bool = True,
        artifact_dir: Optional[str] = None,
        resume: bool = True,
        save_state_every: int = 50,
    ) -> Dict[str, object]:
        """Stream ``n_batches`` candidate batches (batch numbers 1..n_batches; 0 is
        the query batch). With ``artifact_dir``, writes the per-query convergence
        curves as ``convergence.csv`` (and ``convergence.png`` where matplotlib
        imports), and snapshots the running state to ``<artifact_dir>/state.npz``
        every ``save_state_every`` batches, at the end and on SIGTERM/SIGINT;
        ``resume`` picks up from it. The candidate stream is a function of the
        batch number, so a resumed run equals an uninterrupted one."""
        state_file = Path(artifact_dir) / "state.npz" if artifact_dir else None
        history: list = []  # per-batch min-distance snapshots
        start = 0
        writer = self.mesh.rank == 0
        barrier(self.mesh)  # rank 0's last state file is whole before any rank reads it
        if resume and state_file is not None and state_file.exists():
            loaded = self._load_state(state_file)
            if loaded is not None:
                history, start = loaded

        def save_state(batches_done: int) -> None:
            if writer and state_file is not None and history:
                self._save_state(state_file, history, batches_done)

        prev = self.best_dist.cpu().numpy()
        batches_done = start
        with PreemptionGuard() as guard:
            for i in range(start, n_batches):
                requested = agree_max(guard.requested, self.mesh)
                if requested is not None:
                    guard.requested = int(requested)
                    save_state(i)
                    print(f"retrieval: preempted at batch {i}, state saved")
                    break
                improved = self.step(i + 1)
                cur = self.best_dist.cpu().numpy()
                if not (cur <= prev + 1e-6).all():
                    raise AssertionError("min distance must be monotone")
                prev = cur
                history.append(cur.copy())
                batches_done = i + 1
                if batches_done % save_state_every == 0:
                    save_state(batches_done)
                if logger is not None and log_every_improvement and improved.any():
                    self._log_improvements(logger, improved, cur, sample_rate, step=i)
            else:
                save_state(n_batches)
        history_arr = np.stack(history) if history else np.zeros((0,))
        if writer and artifact_dir is not None and len(history):
            _write_convergence_artifacts(artifact_dir, history_arr)
        if guard.requested == signal.SIGINT and batches_done < n_batches:
            # stopped early by ctrl-C (one landing in the final batch does not undo
            # a completed run)
            raise KeyboardInterrupt
        best_params = self.best_params.cpu().numpy()
        query_params = self.query_params.cpu().numpy()
        return {
            "best_dist": self.best_dist.cpu().numpy(),
            "best_audio": self.best_audio.cpu().numpy(),
            "best_params": best_params,
            "query_params": query_params,
            # per-query parameter MAE of the audio-space nearest neighbour
            "nn_param_mae": np.mean(np.abs(best_params - query_params), axis=1),
            "history": history_arr,
            # False when preempted: partial results are not the final metric
            "completed": batches_done >= n_batches,
            "batches_done": batches_done,
        }


def _write_convergence_artifacts(artifact_dir: str, history: np.ndarray) -> None:
    """history [n_batches, n_queries] -> convergence.csv, and convergence.png
    where matplotlib imports (the CSV is the artifact)."""
    out = Path(artifact_dir)
    out.mkdir(parents=True, exist_ok=True)
    n_batches, n_q = history.shape
    with open(out / "convergence.csv", "w") as f:
        f.write("batch," + ",".join(f"query{q}" for q in range(n_q)) + "\n")
        for i in range(n_batches):
            f.write(f"{i}," + ",".join(f"{v:.6g}" for v in history[i]) + "\n")
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for q in range(n_q):
        ax.plot(history[:, q], lw=1)
    ax.set_xlabel("candidate batch")
    ax.set_ylabel("min distance")
    ax.set_title("per-query nearest-neighbour convergence")
    fig.tight_layout()
    fig.savefig(out / "convergence.png", dpi=120)
    plt.close(fig)
