"""The port's pretraining slice against the JAX package, and its guards.

- One f32 train step of the tiny config in both packages from the same weights
  (carried across with ``models/jax_weights.py``) and the same batch number.
- The batch-number -> audio path at 1 s, where the fused render's plain version
  is on the step.
- LARS on the cases of tests/test_lars.py, against the JAX ``fused_lars``.
- The loop, the CLI, and the guards: no JAX in the port, no silent CPU fallback,
  config keys the port does not implement are refused.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_overrides
from inverse_audio_synthesis_tpu.parallel.mesh import create_mesh
from inverse_audio_synthesis_tpu.synth import SynthConfig as JSynthConfig
from inverse_audio_synthesis_tpu.synth import voice as jvoice
from inverse_audio_synthesis_tpu.train.optim import make_optimizer as jmake_optimizer
from inverse_audio_synthesis_tpu.train.optim import make_schedule as jmake_schedule
from inverse_audio_synthesis_tpu.train.optim import total_notfinite
from inverse_audio_synthesis_tpu.train.pretrain import VicregPretrainTask as JaxTask
from inverse_audio_synthesis_tpu.utils.config import load_config as jload_config
from inverse_audio_synthesis_tpu_torch.models.jax_weights import (
    export_jax_variables,
    flatten,
    load_jax_variables,
)
from inverse_audio_synthesis_tpu_torch.train.loop import Trainer
from inverse_audio_synthesis_tpu_torch.train.optim import make_optimizer, make_schedule
from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask
from inverse_audio_synthesis_tpu_torch.train.runsetup import BatchNumberSplit
from inverse_audio_synthesis_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "inverse_audio_synthesis_tpu_torch"
# the tiny config without dropout: dropout masks come from different generators
TINY = tiny_overrides(**{"param_embed.dropout": 0})


def _cpu_task(overrides):
    return VicregPretrainTask(load_config(overrides=list(overrides) + ["platform=cpu"]))


# -- the whole slice: one f32 step against the JAX task -----------------------------


@pytest.fixture(scope="module")
def one_step():
    """One train step from identical weights in both packages (batch number 7)."""
    jtask = JaxTask(jload_config(overrides=TINY), create_mesh(1, 1, devices=jax.devices()[:1]))
    jstate = jtask.init_state()
    variables = jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats})
    task = _cpu_task(TINY)
    state = task.init_state()
    load_jax_variables(state.model, variables)
    jstate, jmetrics = jtask.train_step(jstate, 7)
    state, metrics = task.train_step(state, 7)
    after = jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats})
    return {
        "jax_metrics": {k: float(v) for k, v in jax.device_get(jmetrics).items()},
        "metrics": {k: float(v) for k, v in metrics.items()},
        "before": flatten(variables),
        "jax_after": flatten(after),
        "after": flatten(export_jax_variables(state.model, variables)),
        "state": state,
        "task": task,
    }


def test_one_step_loss_matches_jax(one_step):
    """Loss and its terms. The random-init trunk gives nearly identical audio
    embeddings across the batch of 8, and the projector's BatchNorm divides by
    their small spread, so the towers' ~4e-5 float32 differences grow ~50x in the
    covariance term. Measured: loss 3e-4, repr 1.5e-4, std 6e-5, cov 2e-3."""
    jm, tm = one_step["jax_metrics"], one_step["metrics"]
    assert tm["lr"] == pytest.approx(jm["lr"], rel=1e-6)
    rtol = {"loss": 1e-3, "repr_loss": 1e-3, "std_loss": 1e-3, "cov_loss": 1e-2}
    for term, tol in rtol.items():
        key = f"vicreg/train/{term}"
        assert np.isfinite(tm[key])
        assert tm[key] == pytest.approx(jm[key], rel=tol), key


def test_one_step_updates_match_jax(one_step):
    """Every parameter's update. LARS fixes each decayed tensor's update norm
    (tc * lr * ||w||), so norms agree to 1e-3 (measured 4e-5); directions carry the
    gradients' conditioning (measured cosine >= 0.985). Biases that feed a
    BatchNorm have a zero gradient in exact arithmetic: both sides move them by
    rounding noise only."""
    before, jafter, after = one_step["before"], one_step["jax_after"], one_step["after"]
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
        assert dj @ dt / (nj * nt) > 0.97, key
        assert abs(nt / nj - 1.0) < (1e-3 if before[key].ndim >= 2 else 0.1), key
        checked += 1
    assert checked > 50


def test_one_step_batch_stats_match_jax(one_step):
    """Running statistics: flax momentum and biased variance. Each BatchNorm folded
    (1 - m) * batch statistic in; means are compared in units of (1 - m) * batch std."""
    before, jafter, after = one_step["before"], one_step["jax_after"], one_step["after"]
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


def test_one_step_val_and_embed(one_step):
    task, state = one_step["task"], one_step["state"]
    val = task.val_step(state, 3)
    assert all(np.isfinite(float(v)) for v in val.values())
    audio, _ = task.synthesize(3)
    emb = task.embed_audio(state, audio)
    assert emb.shape == (8, 32) and torch.isfinite(emb).all()


def test_batch_number_to_audio_at_1s_uses_fused_plain_version():
    """1 s geometry (105 x 140 image): the task's synth goes through the fused
    render's plain version; held against the JAX portable render at the repo's
    render bound."""
    task = _cpu_task(TINY + ["image.height=105", "image.width=140",
                             "torchsynth.buffer_size_seconds=1.0", "vicreg.batch_size=4"])
    assert task.voices.fused_render
    audio, params01 = task.synthesize(42)
    jcfg = JSynthConfig(batch_size=4, buffer_size_seconds=1.0, seed=42)
    ref = np.asarray(jvoice.render_voice(jvoice.sample_voice_params(42, jcfg), jcfg))
    np.testing.assert_array_equal(params01.numpy(), np.asarray(jvoice.sample_voice_params(42, jcfg)))
    got = audio[:, 0].numpy()
    assert got.shape == (4, 44100)
    assert np.abs(got - ref).max() < 0.08
    assert np.sqrt(np.mean((got - ref) ** 2)) / np.sqrt(np.mean(ref**2)) < 0.01


# -- LARS and its schedule against the JAX optimizer ----------------------------------


def _updates_both(optim_cfg, batch_size, params, grads):
    jtx, _ = jmake_optimizer(optim_cfg, batch_size)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jupd, jstate = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, jtx.init(jparams), jparams)
    names = sorted(params)
    tparams = [torch.from_numpy(params[k].copy()) for k in names]
    opt, _ = make_optimizer(optim_cfg, batch_size, tparams)
    tupd = opt.updates([torch.from_numpy(grads[k].copy()) for k in names])
    return (
        {k: np.asarray(jupd[k]) for k in names},
        {k: u.numpy() for k, u in zip(names, tupd)},
        int(total_notfinite(jstate)),
        int(opt.total_notfinite),
    )


LARS_CASES = {
    # tests/test_lars.py: flash formula, masking, weight decay, zero gradient
    "flash_formula": ({"base_lr": 2.0, "weight_decay": 1e-6}, 64, 0.1, 0),
    "exclude_bias_and_norm": (
        {"base_lr": 2.0, "weight_decay": 1e-6, "exclude_bias_and_norm": True}, 64, 0.1, 1),
    "weight_decay": ({"base_lr": 2.0, "weight_decay": 0.1}, 256, 0.01, 2),
    "zero_grad": ({"base_lr": 2.0, "weight_decay": 0.1}, 256, 0.0, 3),
    "no_decay_plain_sgd": ({"base_lr": 2.0, "weight_decay": 0.0}, 256, 0.1, 4),
}


@pytest.mark.parametrize("case", sorted(LARS_CASES))
def test_lars_matches_jax_fused_lars(case):
    args, batch_size, gscale, seed = LARS_CASES[case]
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(16, 8).astype(np.float32), "b": rng.randn(8).astype(np.float32),
              "z": np.zeros((4, 4), np.float32)}
    grads = {k: (rng.randn(*v.shape) * gscale).astype(np.float32) for k, v in params.items()}
    jupd, tupd, jbad, tbad = _updates_both({"name": "lars", "args": args}, batch_size, params, grads)
    for k in jupd:
        np.testing.assert_allclose(tupd[k], jupd[k], rtol=1e-5, atol=1e-9, err_msg=k)
    assert jbad == tbad == 0


def test_lars_rejects_nonfinite_and_counts():
    params = {"w": np.ones((4,), np.float32)}
    bad = {"w": np.array([1.0, np.nan, 0.0, 0.0], np.float32)}
    cfg = {"name": "lars", "args": {"base_lr": 2.0, "weight_decay": 0.0}}
    jupd, tupd, jbad, tbad = _updates_both(cfg, 256, params, bad)
    np.testing.assert_array_equal(tupd["w"], 0.0)
    assert jbad == tbad == 1
    # a bad step does not advance the schedule count; a good one after it applies
    w = torch.ones(4)
    opt, _ = make_optimizer(cfg, 256, [w])
    opt.step([torch.from_numpy(bad["w"])])
    assert int(opt.count) == 0 and int(opt.total_notfinite) == 1 and torch.equal(w, torch.ones(4))
    opt.step([torch.full((4,), 0.1)])
    assert int(opt.count) == 1 and float((w - 1).abs().max()) > 0


@pytest.mark.parametrize("step_every", [1, 100])
def test_schedule_matches_optax(step_every):
    cfg = {
        "name": "LinearWarmupCosineAnnealingLR",
        "step_every_nbatches": step_every,
        "args": {"warmup_epochs": 5, "max_epochs": 50, "warmup_start_lr": 0.01, "eta_min": 0.001},
    }
    jsched, tsched = jmake_schedule(cfg, 0.8), make_schedule(cfg, 0.8)
    for step in (0, 1, 4, 5, 6, 20, 49, 50, 80, 250, 5000):
        assert float(tsched(step)) == pytest.approx(float(jsched(step)), rel=1e-6, abs=1e-9), step
    assert make_schedule({"name": None}, 0.5) == 0.5


# -- the loop and the CLI -------------------------------------------------------------


class _Records:
    def __init__(self):
        self.rows = []

    def log(self, metrics, step=None):
        self.rows.append((step, metrics))


def test_trainer_fit_logs_and_validates():
    task = _cpu_task(TINY + ["precision=bf16"])
    state = task.init_state()
    split = BatchNumberSplit(1000, 1, seed=0)
    logger = _Records()
    trainer = Trainer(task, split, logger=logger, limit_train_batches=3,
                      limit_val_batches=2, val_check_interval=3, log_every=2)
    state = trainer.fit(state)
    assert state.step == 3 and int(state.optimizer.count) == 3
    steps = [s for s, m in logger.rows if "vicreg/train/loss" in m]
    assert steps == [0, 1]  # the first step, then every log_every
    train_rows = [m for _, m in logger.rows if "vicreg/train/loss" in m]
    assert all(np.isfinite(m["vicreg/train/loss"]) and m["notfinite_steps"] == 0 for m in train_rows)
    val_rows = [m for _, m in logger.rows if "vicreg/validation/loss" in m]
    assert len(val_rows) == 1 and np.isfinite(val_rows[0]["vicreg/validation/loss"])


def test_cli_runs_two_steps_on_cpu(tmp_path):
    args = [f"{a}" for a in TINY] + [
        "platform=cpu", "vicreg.limit_train_batches=2", "log_every=1",
        f"run_dir={tmp_path}", "num_batches=100",
    ]
    proc = subprocess.run(
        [sys.executable, "-m", "inverse_audio_synthesis_tpu_torch.pretrain", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "checkpoints under" in proc.stdout
    assert (tmp_path / "checkpoints" / "vicreg" / "last").read_text() == "step_000000000002"
    metrics = list(tmp_path.glob("pretrain-torch-*/metrics.jsonl"))
    # the vendored clip's PQMF filter range, then one line per train step
    lines = metrics[0].read_text().splitlines() if len(metrics) == 1 else []
    assert len(lines) == 3 and '"pqmf/band0/min"' in lines[0], lines


# -- guards ---------------------------------------------------------------------------

_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|orbax|inverse_audio_synthesis_tpu)(\.|\s|$)", re.M
)


def test_port_imports_no_jax():
    """Import every module of the port in a fresh interpreter: no JAX module and
    nothing of the JAX package may be loaded."""
    modules = sorted(
        "inverse_audio_synthesis_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'inverse_audio_synthesis_tpu'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert len(modules) >= 42  # the downstream, eval, serving, parallel and utility modules among them
    assert {"inverse_audio_synthesis_tpu_torch.downstream", "inverse_audio_synthesis_tpu_torch.ops.stft",
            "inverse_audio_synthesis_tpu_torch.train.downstream",
            "inverse_audio_synthesis_tpu_torch.train.checkpoint",
            "inverse_audio_synthesis_tpu_torch.eval.retrieval", "inverse_audio_synthesis_tpu_torch.eval.hear",
            "inverse_audio_synthesis_tpu_torch.serve.export",
            "inverse_audio_synthesis_tpu_torch.evaluate_audio_representations",
            "inverse_audio_synthesis_tpu_torch.heareval",
            "inverse_audio_synthesis_tpu_torch.export_model",
            "inverse_audio_synthesis_tpu_torch.parallel.mesh",
            "inverse_audio_synthesis_tpu_torch.parallel.collectives",
            "inverse_audio_synthesis_tpu_torch.parallel.launch",
            "inverse_audio_synthesis_tpu_torch.parallel.jobs",
            "inverse_audio_synthesis_tpu_torch.models.torch_import",
            "inverse_audio_synthesis_tpu_torch.ops.imgscale8",
            "inverse_audio_synthesis_tpu_torch.utils.profiling",
            "inverse_audio_synthesis_tpu_torch.utils.summary",
            "inverse_audio_synthesis_tpu_torch.utils.utils"} <= set(modules)


def test_port_sources_name_no_jax():
    offenders = [
        str(p.relative_to(REPO)) for p in PORT.rglob("*.py") if _FORBIDDEN.search(p.read_text())
    ]
    assert offenders == []
    assert _FORBIDDEN.search("from inverse_audio_synthesis_tpu.ops import x")
    assert not _FORBIDDEN.search("from inverse_audio_synthesis_tpu_torch.ops import x")


def test_no_cuda_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="platform=cpu"):
        VicregPretrainTask(load_config(overrides=TINY))
    assert _cpu_task(TINY).device.type == "cpu"


@pytest.mark.parametrize("override", ["mesh.data=2", "mesh.model=2"])
def test_unsupported_keys_are_refused(override):
    """A mesh larger than the process group (here none: one rank) raises
    ValueError naming both."""
    with pytest.raises(ValueError, match="ranks, but the process group has 1"):
        _cpu_task(TINY + [override])


@pytest.mark.parametrize("overrides", [[], TINY, ["vicreg=fast", "+extra.key=3"]])
def test_config_and_split_copies_match_jax(overrides):
    """The port's copies of the config tree, its loader and the batch-number split
    compose the same keys and draw the same batch numbers as the JAX package's.
    ``audio_tower`` is the port's own key (the AST tower exists only in the
    port); its default builds the tower the JAX package has."""
    from inverse_audio_synthesis_tpu.train.runsetup import BatchNumberSplit as JSplit

    tree = load_config(overrides=overrides).to_dict()
    assert tree.pop("audio_tower")["name"] == "mobilenetv3_small"
    assert tree == jload_config(overrides=overrides).to_dict()
    with pytest.raises(KeyError):
        load_config(overrides=["vicreg.batchsize=64"])
    split, jsplit = BatchNumberSplit(50_000_000, 1, 42), JSplit(50_000_000, 1, 42)
    assert vars(split.sizes) == vars(jsplit.sizes)
    for i in (0, 1, 17, 10**6):
        assert split.train_batch_num(i) == jsplit.train_batch_num(i)
        assert split.val_batch_num(i % split.sizes.val) == jsplit.val_batch_num(i % jsplit.sizes.val)
