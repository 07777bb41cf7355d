"""The port at W=4 over gloo against the JAX package on a mesh of the conftest's
8 virtual CPU devices, from the same weights carried across.

- Pretraining: the JAX task on a (2, 2) mesh (data 2, tensor-parallel projector
  over 2) and the port on a (2, 2) mesh of 4 ranks, one f32 step from the JAX
  init, dropout 0 (the two packages draw masks from different generators),
  within the one-step tolerances of ``tests/test_torch_port_pretrain.py``.
- Downstream: the JAX task on a (2, 1) mesh and the port's (2, 2) world, one
  ``combined`` step with the overrides of ``tests/test_cross_mesh.py:142-151``
  (mel term in global chunks of 4 rows). The geometry and render paths are
  those of ``tests/test_torch_port_downstream.py``: a 60 x 80 pseudo-image, the
  JAX fused render in interpret mode against the port's, ``mel.method`` fft.

The pretraining step keeps the tiny 64 x 64 geometry, which is not the fused
render's: both packages render with their portable ``render_voice``. The port's
world runs in a thread while JAX compiles its steps.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from conftest import tiny_overrides
from inverse_audio_synthesis_tpu.parallel.mesh import create_mesh
from inverse_audio_synthesis_tpu.synth import voice as jvoice
from inverse_audio_synthesis_tpu.train.downstream import AudioToParamsTask as JaxDownstream
from inverse_audio_synthesis_tpu.train.pretrain import VicregPretrainTask as JaxPretrain
from inverse_audio_synthesis_tpu.utils.config import load_config as jload_config
from inverse_audio_synthesis_tpu_torch.models.jax_weights import flatten
from inverse_audio_synthesis_tpu_torch.parallel import jobs
from inverse_audio_synthesis_tpu_torch.parallel.launch import spawn_world

TINY = tiny_overrides(**{"param_embed.dropout": 0})
FUSED = {"image.height": 60, "image.width": 80, "torchsynth.buffer_size_seconds": 14400 / 44100}
DOWNSTREAM = tiny_overrides(**FUSED, **{"param_embed.dropout": 0}) + [
    "audio_to_params.batch_size=8", "audio_to_params.dropout=0.0", "audio_to_params.loss=combined",
    "audio_to_params.loss_weights.param_mse=1.0", "audio_to_params.loss_weights.embedding=1.0",
    "audio_to_params.loss_weights.mel_l1=0.25", "audio_to_params.mel_chunk=4",
    "mel.method=fft", "mel.test_method=fft",
]
PORT_MESH = ["platform=cpu", "mesh.data=2", "mesh.model=2"]


def _vars(state):
    return jax.device_get({"params": state.params, "batch_stats": state.batch_stats})


def _mesh(data, model):
    return create_mesh(data, model, devices=jax.devices()[: data * model])


@pytest.fixture(scope="module")
def both():
    """The JAX steps on their meshes and the port's W=4 world from their weights."""
    jtask = JaxPretrain(jload_config(overrides=TINY), _mesh(2, 2))
    jstate = jtask.init_state()
    variables = _vars(jstate)
    cfg = jload_config(overrides=DOWNSTREAM)
    mesh = _mesh(2, 1)
    jpre = JaxPretrain(cfg, mesh)
    jpre_state = jpre.init_state()
    jdown = JaxDownstream(cfg, mesh, jpre, jpre_state)
    # both sides through a kernel path: the JAX fused render in interpret mode
    jdown._render = lambda p, noise: jvoice.render_voice_fused(p, jdown.synth, True, None, noise)
    jhead = jdown.init_state()
    head = _vars(jhead)
    calls = [
        ("pretrain", dict(overrides=TINY + PORT_MESH, variables=variables, val_batch=None)),
        ("downstream", dict(overrides=DOWNSTREAM + PORT_MESH, tower_variables=_vars(jpre_state),
                            head_variables=head)),
    ]
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(spawn_world, 4, jobs.run_all, (calls,), "cpu", None, 300)
        jstate, jm = jtask.train_step(jstate, 7)
        jhead, jdm = jdown.train_step(jhead, 7)
        ranks = port.result()
    pre = {"before": variables, "jax_after": _vars(jstate),
           "jax_metrics": {k: float(v) for k, v in jax.device_get(jm).items()}}
    down = {"before": head, "jax_after": _vars(jhead),
            "jax_metrics": {k: float(v) for k, v in jax.device_get(jdm).items()}}
    pre["port"], down["port"] = ranks[0]
    pre["ranks"], down["ranks"] = [r[0] for r in ranks], [r[1] for r in ranks]
    return pre, down


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def test_w4_pretrain_step_matches_jax_2x2_mesh(both):
    """tests/test_torch_port_pretrain.py:82-135 on every rank's metrics and rank
    0's gathered tree: loss terms (rel 1e-3, cov 1e-2), update cosines > 0.97
    and norm ratios (1e-3 for matrices, 0.1 for vectors), running statistics."""
    r, _ = both
    for rank in r["ranks"]:
        tm, jm = rank["metrics"][0], r["jax_metrics"]
        assert tm["lr"] == pytest.approx(jm["lr"], rel=1e-6)
        for term, tol in {"loss": 1e-3, "repr_loss": 1e-3, "std_loss": 1e-3, "cov_loss": 1e-2}.items():
            key = f"vicreg/train/{term}"
            assert np.isfinite(tm[key]) and tm[key] == pytest.approx(jm[key], rel=tol), key
    before, jafter = flatten(r["before"]), flatten(r["jax_after"])
    after = flatten(r["port"]["jax_after"])
    checked = 0
    for key in before:
        if not key.startswith("params/"):
            continue
        dj = (jafter[key] - before[key]).astype(np.float64).ravel()
        dt = (after[key] - before[key]).astype(np.float64).ravel()
        nj, nt = np.linalg.norm(dj), np.linalg.norm(dt)
        if nj < 1e-6:
            assert nt < 1e-5, key
            continue
        assert _cos(dj, dt) > 0.97, key
        assert abs(nt / nj - 1.0) < (1e-3 if before[key].ndim >= 2 else 0.1), key
        checked += 1
    assert checked > 50
    n = 0
    for key in before:
        if not (key.startswith("batch_stats/") and key.endswith("/mean")):
            continue
        var = key[: -len("mean")] + "var"
        m = 0.99 if "/vision_model/" in key else 0.9
        batch_var = (jafter[var] - m * before[var]) / (1.0 - m)
        unit = (1.0 - m) * np.sqrt(max(batch_var.max(), 0.0)) + 1e-12
        assert np.abs(after[key] - jafter[key]).max() < 1e-2 * unit, key
        np.testing.assert_allclose(after[var], jafter[var], rtol=1e-5,
                                   atol=1e-2 * (1.0 - m) * max(batch_var.max(), 0.0))
        n += 1
    assert n > 30


def test_w4_downstream_combined_step_matches_jax_2x1_mesh(both):
    """Logged values rel 1e-4 and running statistics rel 1e-4, as
    tests/test_torch_port_downstream.py holds them; update cosines >= 0.97 and
    norm ratios within 5e-2. With these weights (embedding 1, mel 0.25) the two
    packages depart at one rank as far: measured against the JAX (1, 1) mesh,
    the least cosine 0.9776 (lin3) and norm ratios within 1.3e-2, and the same
    at (2, 1) against this world (the grad-through-synth term: its phases round
    differently in the two packages' kernels)."""
    _, r = both
    jm = r["jax_metrics"]
    for rank in r["ranks"]:
        tm = rank["metrics"]
        assert set(tm) == set(jm)
        for key in jm:
            assert np.isfinite(tm[key]) and tm[key] == pytest.approx(jm[key], rel=1e-4), key
    before, jafter = flatten(r["before"]), flatten(r["jax_after"])
    after = flatten(r["port"]["jax_after"])
    checked = 0
    for key in before:
        if not key.startswith("params/"):
            continue
        dj, dt = jafter[key] - before[key], after[key] - before[key]
        if np.linalg.norm(dj) < 1e-5:  # biases that feed a BatchNorm: rounding noise only
            assert np.linalg.norm(dt) < 1e-5, key
            continue
        assert _cos(dj, dt) >= 0.97, key
        assert np.linalg.norm(dt) / np.linalg.norm(dj) == pytest.approx(1.0, rel=5e-2), key
        checked += 1
    assert checked == 8
    for key in before:
        if key.startswith("batch_stats/"):
            np.testing.assert_allclose(after[key], jafter[key], rtol=1e-4, atol=1e-6, err_msg=key)
