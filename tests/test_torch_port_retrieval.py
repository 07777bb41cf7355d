"""The port's retrieval eval against the JAX package's, and its own guarantees.

- The evaluator's state machine against ``inverse_audio_synthesis_tpu/eval/retrieval.py``:
  ``render_voice_auto`` is replaced in both modules (here, in the test only) by
  one elementwise function of the parameters and the noise, so both see the same
  audio bit for bit, and both embed with the same numpy linear map. The candidate
  noise is keyed per sub-chunk by ``row_offset`` in JAX and sliced from one
  buffer in the port, so the comparison also holds the keying.
- End to end: the tiny config's towers with the JAX weights, the real render
  (the tiny geometry is not the fused render's: both use ``render_voice``).
- The port alone: an exact self-match, a bit-identical resume, the CSV, the
  planted-query gate with its floor, and the CLI on the CPU.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_overrides
from inverse_audio_synthesis_tpu.eval import retrieval as jretrieval
from inverse_audio_synthesis_tpu.parallel.mesh import create_mesh
from inverse_audio_synthesis_tpu.synth import SynthConfig as JSynthConfig
from inverse_audio_synthesis_tpu.synth import modules as jmodules
from inverse_audio_synthesis_tpu.train.pretrain import VicregPretrainTask as JaxPretrain
from inverse_audio_synthesis_tpu.train.pretrain import synth_config_from_cfg as jsynth_from_cfg
from inverse_audio_synthesis_tpu.utils.config import load_config as jload_config
from inverse_audio_synthesis_tpu_torch.eval import retrieval as tretrieval
from inverse_audio_synthesis_tpu_torch.models.jax_weights import load_jax_variables
from inverse_audio_synthesis_tpu_torch.synth import SynthConfig
from inverse_audio_synthesis_tpu_torch.synth.voice import make_noise, sample_voice_params
from inverse_audio_synthesis_tpu_torch.train.checkpoint import CheckpointManager
from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask, synth_config_from_cfg
from inverse_audio_synthesis_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = tiny_overrides(**{"param_embed.dropout": 0})

# -- the state machine against JAX, on the same audio ------------------------------

T_SM = 2205  # 0.05 s voices
RAMP = np.linspace(-1.0, 1.0, T_SM, dtype=np.float32)
W_EMBED = (np.random.RandomState(0).randn(T_SM, 8) / np.sqrt(T_SM)).astype(np.float32)


def _jfake(params01, config, noise=None):
    """(noise + p1) * (ramp + p0): adds, then one multiply, so no contraction
    into an FMA can make the two packages' audio differ."""
    if noise is None:
        noise = jmodules.noise(jax.random.PRNGKey(config.noise_seed), params01.shape[0], config.buffer_size)
    return (noise + params01[:, 1:2]) * (jnp.asarray(RAMP) + params01[:, 0:1])


def _tfake(params01, config, noise=None):
    if noise is None:
        noise = make_noise(config, params01.device, params01.shape[0])
    return (noise + params01[:, 1:2]) * (torch.from_numpy(RAMP) + params01[:, 0:1])


def _ref_distances(query_synth, candidate_synth, n_batches):
    """float64 distances of every streamed candidate, [n_batches, n_q, bs], from
    the port's bit-identical params and noise."""
    def emb(params, noise):
        audio = _tfake(params, None, noise).numpy().astype(np.float64)
        return audio @ W_EMBED.astype(np.float64)

    q = emb(sample_voice_params(0, query_synth), make_noise(query_synth))
    noise = make_noise(candidate_synth)
    out = []
    for b in range(1, n_batches + 1):
        c = emb(sample_voice_params(b, candidate_synth), noise)
        out.append(np.sqrt(((q[:, None, :] - c[None, :, :]) ** 2).sum(-1)))
    return np.stack(out)


def test_state_machine_matches_jax(monkeypatch):
    """Improvement masks and the nearest neighbour's parameters equal wherever the
    best-vs-second margin exceeds 1e-4 (relative); best distances and history to
    1e-5 relative (the two float32 matmuls sum in different orders)."""
    monkeypatch.setattr(jretrieval, "render_voice_auto", _jfake)
    monkeypatch.setattr(tretrieval, "render_voice_auto", _tfake)
    secs = T_SM / 44100
    n_batches, inner = 4, 8
    jq, jc = JSynthConfig(batch_size=4, buffer_size_seconds=secs), JSynthConfig(batch_size=16, buffer_size_seconds=secs)
    tq, tc = SynthConfig(batch_size=4, buffer_size_seconds=secs), SynthConfig(batch_size=16, buffer_size_seconds=secs)
    jev = jretrieval.RetrievalEvaluator(
        lambda v, a: a[:, 0, :] @ v["W"], {"W": jnp.asarray(W_EMBED)}, jq, jc, inner_chunk=inner)
    w = torch.from_numpy(W_EMBED)
    tev = tretrieval.RetrievalEvaluator(lambda a: a[:, 0, :] @ w, tq, tc, inner_chunk=inner, device="cpu")
    np.testing.assert_array_equal(tev.query_audio.numpy(), np.asarray(jev.query_audio))

    jmasks = [jev.step(b) for b in range(1, n_batches + 1)]
    tmasks = [tev.step(b) for b in range(1, n_batches + 1)]
    d = _ref_distances(tq, tc, n_batches)
    batch_min = d.min(axis=2)  # [n_batches, n_q]
    running = np.minimum.accumulate(batch_min, axis=0)
    prev = np.vstack([np.full((1, 4), np.inf), running[:-1]])
    clear = np.abs(batch_min - prev) > 1e-4 * running
    ref_masks = batch_min < prev
    assert clear.sum() >= 8
    for b in range(n_batches):
        np.testing.assert_array_equal(tmasks[b][clear[b]], ref_masks[b][clear[b]])
        np.testing.assert_array_equal(np.asarray(jmasks[b])[clear[b]], ref_masks[b][clear[b]])
    np.testing.assert_allclose(tev.best_dist.numpy(), np.asarray(jev.best_dist), rtol=1e-5)
    np.testing.assert_allclose(tev.best_dist.numpy(), running[-1], rtol=1e-5)

    flat = d.transpose(1, 0, 2).reshape(4, -1)
    two = np.sort(flat, axis=1)[:, :2]
    clear_nn = (two[:, 1] - two[:, 0]) > 1e-4 * two[:, 0]
    assert clear_nn.sum() >= 3
    tp, jp = tev.best_params.numpy(), np.asarray(jev.best_params)
    np.testing.assert_array_equal(tp[clear_nn], jp[clear_nn])
    np.testing.assert_array_equal(tev.best_audio.numpy()[clear_nn], np.asarray(jev.best_audio)[clear_nn])


def test_run_history_and_csv_match_jax(monkeypatch, tmp_path):
    """``run``: history and final distances to 1e-5 relative, the same result keys,
    and the convergence CSV of the JAX test's shape (header + one row a batch)."""
    monkeypatch.setattr(jretrieval, "render_voice_auto", _jfake)
    monkeypatch.setattr(tretrieval, "render_voice_auto", _tfake)
    secs = T_SM / 44100
    jev = jretrieval.RetrievalEvaluator(
        lambda v, a: a[:, 0, :] @ v["W"], {"W": jnp.asarray(W_EMBED)},
        JSynthConfig(batch_size=4, buffer_size_seconds=secs), JSynthConfig(batch_size=8, buffer_size_seconds=secs),
        inner_chunk=4)
    w = torch.from_numpy(W_EMBED)
    tev = tretrieval.RetrievalEvaluator(
        lambda a: a[:, 0, :] @ w, SynthConfig(batch_size=4, buffer_size_seconds=secs),
        SynthConfig(batch_size=8, buffer_size_seconds=secs), inner_chunk=4, device="cpu")
    jres = jev.run(n_batches=4, artifact_dir=str(tmp_path / "jax"))
    tres = tev.run(n_batches=4, artifact_dir=str(tmp_path / "port"))
    assert set(tres) == set(jres)
    assert tres["completed"] and tres["batches_done"] == 4
    np.testing.assert_allclose(tres["history"], jres["history"], rtol=1e-5)
    assert tres["history"].shape == (4, 4) and (np.diff(tres["history"], axis=0) <= 1e-6).all()
    np.testing.assert_allclose(tres["history"][-1], tres["best_dist"], rtol=1e-6)
    lines = (tmp_path / "port" / "convergence.csv").read_text().strip().splitlines()
    assert len(lines) == 5 and lines[0] == "batch,query0,query1,query2,query3"
    jlines = (tmp_path / "jax" / "convergence.csv").read_text().strip().splitlines()
    assert [len(l.split(",")) for l in lines] == [len(l.split(",")) for l in jlines]


# -- end to end against JAX, the tiny towers -----------------------------------------


@pytest.fixture(scope="module")
def towers():
    """The JAX tiny pretrain task and weights, and the port's task with them."""
    jcfg = jload_config(overrides=TINY)
    jtask = JaxPretrain(jcfg, create_mesh(1, 1, devices=jax.devices()[:1]))
    jstate = jtask.init_state()
    variables = jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats})
    cfg = load_config(overrides=TINY + ["platform=cpu"])
    task = VicregPretrainTask(cfg)
    state = task.init_state()
    load_jax_variables(state.model, variables)
    return jcfg, jtask, variables, cfg, task, state


def _jax_evaluator(towers, **kw):
    jcfg, jtask, variables, _, _, _ = towers

    def embed(v, audio):
        return jtask.model.apply(v, audio, train=False, method=jtask.model.embed_audio)

    return jretrieval.RetrievalEvaluator(
        embed, variables, jsynth_from_cfg(jcfg, 4), jsynth_from_cfg(jcfg, 8), **kw)


def _port_evaluator(towers, q=4, c=8, **kw):
    _, _, _, cfg, task, state = towers
    return tretrieval.RetrievalEvaluator(
        lambda a: task.project_audio(state, a), synth_config_from_cfg(cfg, q),
        synth_config_from_cfg(cfg, c), device="cpu", **kw)


def test_end_to_end_matches_jax(towers):
    """The portable renders agree to <= 0.08 max / 0.01 rel-rms (the repo's render
    bound). Carried through the eval-mode towers as a relative error, that bound
    holds the query embeddings within 1e-2 of the largest value (measured 7.7e-6:
    the random-init towers barely react to the audio). Best distances agree to
    5e-2 relative (measured 1.0e-4); the nearest neighbours' parameters are equal
    wherever the best-vs-second margin exceeds 0.1 of the distance (3 of 4
    queries)."""
    jev, tev = _jax_evaluator(towers, inner_chunk=4), _port_evaluator(towers, inner_chunk=4)
    jq, tq = np.asarray(jev.query_emb), tev.query_emb.numpy()
    err = np.abs(tq - jq).max() / np.abs(jq).max()
    assert err < 1e-2, err
    np.testing.assert_array_equal(tev.query_params.numpy(), np.asarray(jev.query_params))
    jres, tres = jev.run(n_batches=2), tev.run(n_batches=2)
    np.testing.assert_allclose(tres["best_dist"], jres["best_dist"], rtol=5e-2)
    # margins from the port's own distances to every candidate
    d = []
    for b in (1, 2):
        params = sample_voice_params(b, tev.candidate_synth)
        audio = tretrieval.render_voice_auto(params, tev.candidate_synth, tev._noise)
        d.append(tretrieval.cdist(tev.query_emb, tev.embed_fn(audio[:, None, :])).numpy())
    two = np.sort(np.concatenate(d, axis=1), axis=1)[:, :2]
    clear = (two[:, 1] - two[:, 0]) > 0.1 * two[:, 0]
    assert clear.any()
    np.testing.assert_array_equal(tres["best_params"][clear], jres["best_params"][clear])


# -- the port alone --------------------------------------------------------------------


def test_exact_self_match(towers):
    """Candidate synth = query synth: candidate batch 2 reproduces the queries
    (batch-keyed params, position-keyed noise), so the stream retrieves them at
    distance ~0 with an exact parameter copy (the JAX package's slow test)."""
    ev = _port_evaluator(towers, q=4, c=4, query_batch_num=2)
    result = ev.run(n_batches=3)
    np.testing.assert_allclose(result["best_dist"], 0.0, atol=1e-3)
    np.testing.assert_array_equal(result["best_params"], result["query_params"])
    np.testing.assert_array_equal(result["nn_param_mae"], 0.0)


def test_resume_bit_identical(towers, tmp_path):
    """Interrupted after 2 of 5 batches and resumed from state.npz: the same
    distances, history, audio and parameters as one uninterrupted run; another
    inner_chunk does not resume."""
    full = _port_evaluator(towers, inner_chunk=4).run(n_batches=5, artifact_dir=str(tmp_path / "full"))
    part = str(tmp_path / "part")
    first = _port_evaluator(towers, inner_chunk=4).run(n_batches=2, artifact_dir=part, save_state_every=1)
    assert first["batches_done"] == 2 and (tmp_path / "part" / "state.npz").exists()
    resumed = _port_evaluator(towers, inner_chunk=4).run(n_batches=5, artifact_dir=part, save_state_every=1)
    for key in ("best_dist", "history", "best_audio", "best_params"):
        np.testing.assert_array_equal(full[key], resumed[key], err_msg=key)
    assert resumed["completed"] and resumed["batches_done"] == 5
    fresh = _port_evaluator(towers, inner_chunk=8).run(n_batches=5, artifact_dir=part)
    assert fresh["history"].shape[0] == 5
    (tmp_path / "part" / "state.npz").write_bytes(b"torn")  # an unreadable state is ignored
    again = _port_evaluator(towers, inner_chunk=8).run(n_batches=1, artifact_dir=part)
    assert again["batches_done"] == 1


@pytest.mark.parametrize("signum", [signal.SIGTERM, signal.SIGINT])
def test_preemption_saves_state_and_a_rerun_resumes(towers, tmp_path, signum):
    """A signal during batch 1 stops the run after it with state.npz saved: SIGTERM
    returns completed=False (the CLI exits 75), SIGINT raises KeyboardInterrupt;
    the rerun resumes at batch 1 and ends where an uninterrupted run does."""
    ev = _linear_evaluator(towers)
    step = ev.step

    def step_then_signal(batch_num):
        mask = step(batch_num)
        os.kill(os.getpid(), signum)
        return mask

    ev.step = step_then_signal
    if signum == signal.SIGINT:
        with pytest.raises(KeyboardInterrupt):
            ev.run(n_batches=3, artifact_dir=str(tmp_path))
    else:
        partial = ev.run(n_batches=3, artifact_dir=str(tmp_path))
        assert not partial["completed"] and partial["batches_done"] == 1
    with np.load(tmp_path / "state.npz") as z:
        assert int(z["batches_done"]) == 1
    resumed = _linear_evaluator(towers).run(n_batches=3, artifact_dir=str(tmp_path))
    full = _linear_evaluator(towers).run(n_batches=3)
    assert resumed["completed"] and resumed["batches_done"] == 3
    np.testing.assert_array_equal(resumed["history"], full["history"])


def _linear_evaluator(towers, **kw):
    _, _, _, cfg, _, _ = towers
    t = synth_config_from_cfg(cfg, 4).buffer_size
    w = torch.from_numpy((np.random.RandomState(1).randn(t, 16) / np.sqrt(t)).astype(np.float32))
    return tretrieval.RetrievalEvaluator(
        lambda a: a[:, 0, :] @ w, synth_config_from_cfg(cfg, 4), synth_config_from_cfg(cfg, 8),
        device="cpu", **kw)


@pytest.mark.parametrize("embedding", ["towers", "linear"])
def test_planted_gate_passes_and_catches_miskeyed_noise(towers, embedding):
    """The planted queries sit at ~0 (CPU float32: measured <= 1.7e-7 through the
    towers, 0 through the linear map); with the candidate buffer keyed one row
    off, the gate fails (measured self-distances up to 2.1e-4 against a median
    of 1.2e-4 between the towers' queries, and up to 3.2 against 1.3 for the
    linear map)."""
    ev = _port_evaluator(towers, inner_chunk=4) if embedding == "towers" else _linear_evaluator(towers)
    diag, d = ev.planted_query_distance()
    assert d.shape == (4, 4) and (diag < 1e-4).all(), diag
    ev.assert_planted_queries_found()
    ev._noise = make_noise(ev.candidate_synth, batch_size=8, row_offset=1)
    with pytest.raises(AssertionError, match="planted-query check failed"):
        ev.assert_planted_queries_found()


def test_planted_gate_floor_passes_a_collapsed_embedding(towers):
    """A collapsed embedding, a constant plus noise at 1e-3 of its norm that differs
    between calls (as bf16 rounding differs between batch sizes): its inter-query
    distances are rounding-sized, so the JAX gate's scale (their median, floored at
    1e-6) fails its self-match; the floor at PLANTED_FLOOR_NORM of the norm passes it."""
    gen = torch.Generator().manual_seed(0)
    const = torch.full((16,), 3.0)

    def collapsed(audio):
        noise = torch.randn((audio.shape[0], 16), generator=gen)
        return const + noise * (1e-3 * const.norm() / 4.0)  # |noise| ~ 1e-3 |const|

    _, _, _, cfg, _, _ = towers
    ev = tretrieval.RetrievalEvaluator(
        collapsed, synth_config_from_cfg(cfg, 4), synth_config_from_cfg(cfg, 8), device="cpu")
    diag, d = ev.planted_query_distance()
    median_off = np.median(d[~np.eye(4, dtype=bool)])
    assert not (diag <= 0.05 * median_off).all()  # the JAX gate's scale would fail it
    ev.assert_planted_queries_found()


def test_cdist_matches_jax_and_torch():
    rng = np.random.RandomState(0)
    a, b = rng.randn(5, 7).astype(np.float32), rng.randn(9, 7).astype(np.float32)
    ours = tretrieval.cdist(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jretrieval.cdist(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours, torch.cdist(torch.from_numpy(a), torch.from_numpy(b)).numpy(), rtol=1e-4, atol=1e-4)
    assert (tretrieval.cdist(torch.from_numpy(a), torch.from_numpy(a)).numpy() >= 0).all()


def test_inner_chunk_must_divide_the_batch(towers):
    with pytest.raises(ValueError, match="inner_chunk"):
        _linear_evaluator(towers, inner_chunk=3)


# -- the CLI ---------------------------------------------------------------------------

FUSED = tiny_overrides(**{  # the 60 x 80 size the fused render takes (its plain version here)
    "image.height": 60, "image.width": 80, "torchsynth.buffer_size_seconds": 14400 / 44100,
})


def test_cli_runs_on_cpu(tmp_path):
    cfg = load_config(overrides=FUSED + ["platform=cpu"])
    task = VicregPretrainTask(cfg)
    assert task.fused_render
    CheckpointManager(str(tmp_path / "checkpoints" / "vicreg")).save(task.init_state(), 1)
    args = FUSED + [
        "platform=cpu", f"run_dir={tmp_path}", "retrieval.n_batches=2", "retrieval.test_batch_size=4",
        "retrieval.predict_batch_size=8", "retrieval.inner_chunk=4",
    ]
    proc = subprocess.run(
        [sys.executable, "-m", "inverse_audio_synthesis_tpu_torch.evaluate_audio_representations", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "2"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "loaded vicreg checkpoint step 1" in proc.stdout
    assert "planted-query check OK" in proc.stdout and "NN param-MAE" in proc.stdout
    assert (tmp_path / "retrieval" / "convergence.csv").exists()
    assert (tmp_path / "retrieval" / "state.npz").exists()
    metrics = list(tmp_path.glob("retrieval-torch-*/metrics.jsonl"))
    assert len(metrics) == 1 and "retrieval/mean_nn_param_mae" in metrics[0].read_text()
