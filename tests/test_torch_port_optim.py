"""The port's float32 masters (``weights_bf16``) and momentum optimizers against
the JAX package's ``with_fp32_master`` and ``make_optimizer(momentum=...)``."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from conftest import tiny_overrides
from inverse_audio_synthesis_tpu.train.optim import make_optimizer as jmake_optimizer
from inverse_audio_synthesis_tpu.train.optim import total_notfinite
from inverse_audio_synthesis_tpu.train.optim import with_fp32_master
from inverse_audio_synthesis_tpu_torch.train.checkpoint import CheckpointManager
from inverse_audio_synthesis_tpu_torch.train.optim import Fp32Master, make_optimizer
from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask
from inverse_audio_synthesis_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

SCHEDULE = {"name": "LinearWarmupCosineAnnealingLR",
            "args": {"warmup_epochs": 2, "max_epochs": 10, "warmup_start_lr": 0.01, "eta_min": 0.001}}


def _params(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(16, 8).astype(np.float32), "b": rng.randn(8).astype(np.float32),
            "z": np.zeros((4, 4), np.float32)}


def _grads(params, seed, nan=False):
    rng = np.random.RandomState(100 + seed)
    g = {k: (rng.randn(*v.shape) * 0.1).astype(np.float32) for k, v in params.items()}
    if nan:
        g["w"][3, 2] = np.nan
    return g


def _bf16(x: np.ndarray) -> np.ndarray:
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


# -- float32 masters ------------------------------------------------------------------


def test_fp32_master_matches_jax_with_fp32_master():
    """Three updates of with_fp32_master(fused LARS) on bf16-stored 2-D weights,
    the same bf16 gradients on both sides: masters and stored weights within
    test_lars_matches_jax_fused_lars's bound, the stored ones equal to
    bf16(master)."""
    cfg = {"name": "lars", "args": {"base_lr": 2.0, "weight_decay": 1e-6}}
    p0 = _params(0)
    names = sorted(p0)
    jtx = with_fp32_master(jmake_optimizer(cfg, 64, SCHEDULE)[0])
    jp = {k: jnp.asarray(v, jnp.bfloat16 if v.ndim >= 2 else jnp.float32) for k, v in p0.items()}
    jstate = jtx.init(jp)
    tp = [torch.from_numpy(p0[k]).to(torch.bfloat16 if p0[k].ndim >= 2 else torch.float32) for k in names]
    opt = Fp32Master(tp, lambda masters: make_optimizer(cfg, 64, masters, SCHEDULE, names=names)[0], names)
    assert opt.narrow == [names.index("w"), names.index("z")]
    for step in range(3):
        g = {k: (_bf16(v) if v.ndim >= 2 else v) for k, v in _grads(p0, step).items()}
        upd, jstate = jtx.update({k: jnp.asarray(v, jp[k].dtype) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(g[k]).to(tp[i].dtype) for i, k in enumerate(names)])
    for i, k in enumerate(names):
        np.testing.assert_allclose(opt.master[i].numpy(), np.asarray(jstate.master[k]), rtol=1e-5, atol=1e-9,
                                   err_msg=k)
        np.testing.assert_allclose(tp[i].float().numpy(), np.asarray(jp[k], np.float32), rtol=1e-5, atol=1e-9,
                                   err_msg=k)
        assert torch.equal(tp[i], opt.master[i].to(tp[i].dtype)), k
    assert int(opt.count) == 3 and int(opt.total_notfinite) == 0
    assert sorted(opt.state_dict()) == ["count", "master.w", "master.z", "total_notfinite"]


@pytest.fixture(scope="module")
def bf16_runs():
    """Three steps of the tiny config at bf16 precision, with and without
    weights_bf16 (tests/test_precision_and_config.py:112)."""
    out = {}
    for storage in ("bf16", "f32"):
        over = ["weights_bf16=true"] if storage == "bf16" else []
        task = VicregPretrainTask(load_config(overrides=tiny_overrides(precision="bf16") + over + ["platform=cpu"]))
        state = task.init_state()
        losses = []
        for i in range(3):
            state, m = task.train_step(state, 10 + i)
            losses.append(float(m["vicreg/train/loss"]))
        out[storage] = (task, state, losses)
    return out


def test_weights_bf16_storage_and_losses(bf16_runs):
    task, state, losses = bf16_runs["bf16"]
    _, _, losses_f = bf16_runs["f32"]
    for p in state.model.parameters():
        assert p.dtype == (torch.bfloat16 if p.dim() >= 2 else torch.float32)
    opt = state.optimizer
    assert isinstance(opt, Fp32Master) and all(m.dtype == torch.float32 for m in opt.master)
    for i in opt.narrow:
        assert torch.equal(opt.params[i], opt.master[i].to(torch.bfloat16))
    assert np.isfinite(losses).all() and int(opt.total_notfinite) == 0 and int(opt.count) == 3
    np.testing.assert_allclose(losses, losses_f, rtol=0.05)


def test_weights_bf16_checkpoint_restores_the_masters(bf16_runs, tmp_path):
    task, state, _ = bf16_runs["bf16"]
    CheckpointManager(str(tmp_path)).save(state, 3)
    fresh = CheckpointManager(str(tmp_path)).restore(task.init_state())
    assert fresh.step == 3
    for a, b in zip(state.optimizer.master, fresh.optimizer.master):
        assert torch.equal(a, b)
    for a, b in zip(state.model.state_dict().values(), fresh.model.state_dict().values()):
        assert torch.equal(a, b)


def test_weights_bf16_at_f32_precision():
    """JAX applies weights_bf16 whatever the precision, and flax promotes the bf16
    weights to the float32 compute; the port's layers do the same outside
    autocast."""
    task = VicregPretrainTask(load_config(overrides=tiny_overrides() + ["weights_bf16=true", "platform=cpu"]))
    state = task.init_state()
    state, m = task.train_step(state, 0)
    assert np.isfinite(float(m["vicreg/train/loss"])) and int(state.optimizer.total_notfinite) == 0
    assert state.model.projector.lin0.weight.dtype == torch.bfloat16


# -- momentum ------------------------------------------------------------------------


MOMENTUM_CASES = {
    "lars": {"name": "lars", "args": {"base_lr": 2.0, "weight_decay": 1e-6}},
    "lars_exclude_bias_and_norm": {"name": "lars", "args": {"base_lr": 2.0, "weight_decay": 1e-3,
                                                            "exclude_bias_and_norm": True}},
    "sgd": {"name": "sgd", "args": {"lr": 0.1}},
}


@pytest.mark.parametrize("case", sorted(MOMENTUM_CASES))
def test_momentum_matches_jax(case):
    """make_optimizer(momentum=0.9) over 3 updates, the second non-finite: the
    parameters after each within rtol 1e-5; the rejected step leaves the trace,
    the count and the parameters as they were and is counted."""
    cfg = MOMENTUM_CASES[case]
    p0 = _params(1)
    names = sorted(p0)
    jtx, _ = jmake_optimizer(cfg, 256, SCHEDULE, momentum=0.9)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jtx.init(jp)
    tp = [torch.from_numpy(p0[k].copy()) for k in names]
    opt, _ = make_optimizer(cfg, 256, tp, SCHEDULE, momentum=0.9, names=names)
    for step in range(3):
        g = _grads(p0, step, nan=step == 1)
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        trace = [t.clone() for t in opt.trace]
        before = [p.clone() for p in tp]
        opt.step([torch.from_numpy(g[k]) for k in names])
        if step == 1:
            assert all(torch.equal(a, b) for a, b in zip(trace, opt.trace))
            assert all(torch.equal(a, b) for a, b in zip(before, tp))
            assert int(opt.count) == 1
        for i, k in enumerate(names):
            np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-9,
                                       err_msg=f"{k} step {step}")
    assert int(opt.total_notfinite) == int(total_notfinite(jstate)) == 1 and int(opt.count) == 2
    assert sorted(opt.state_dict()) == ["count", "total_notfinite", "trace.b", "trace.w", "trace.z"]


def test_zero_momentum_keeps_the_fused_optimizers():
    p = [torch.zeros(4, 4)]
    for cfg in MOMENTUM_CASES.values():
        opt, _ = make_optimizer(cfg, 256, p)
        assert sorted(opt.state_dict()) == ["count", "total_notfinite"]


def test_per_parameter_state_is_split_like_its_parameter():
    """Under tensor parallelism a checkpoint splits the optimizer's masters and
    traces as it splits their parameters: the state-dict keys end in the
    parameter's name (a stand-in mesh, rank 1 of a model group of 2)."""
    from inverse_audio_synthesis_tpu_torch.parallel.mesh import Mesh, local_state_dict

    mesh = Mesh(data=1, model=2, data_index=0, model_index=1, data_group=object(), model_group=object())
    full = {"count": torch.tensor(3, dtype=torch.int32),
            "master.projector.lin0.weight": torch.arange(8.0).reshape(4, 2),
            "trace.projector.lin_final.weight": torch.arange(8.0).reshape(2, 4),
            "master.backbone_param.lin3.weight": torch.ones(2, 2)}
    local = local_state_dict(full, mesh)
    assert torch.equal(local["master.projector.lin0.weight"], full["master.projector.lin0.weight"][2:])
    assert torch.equal(local["trace.projector.lin_final.weight"], full["trace.projector.lin_final.weight"][:, 2:])
    assert local["count"] is full["count"]
    assert local["master.backbone_param.lin3.weight"] is full["master.backbone_param.lin3.weight"]
