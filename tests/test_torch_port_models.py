"""The port's front end and towers against the JAX package, on identical weights.

Weights come from the JAX modules' own init and cross through
``models/jax_weights.py``; inputs are made with numpy from a seed. Everything runs
in float32 on the CPU, where the comparisons measure the algorithm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from pathlib import Path

from inverse_audio_synthesis_tpu.models.audioembed import AudioEmbedding as JAudioEmbedding
from inverse_audio_synthesis_tpu.models.mobilenetv3 import MobileNetV3Small as JMobileNet
from inverse_audio_synthesis_tpu.models.paramembed import ParamEmbed as JParamEmbed
from inverse_audio_synthesis_tpu.models.vicreg import Projector as JProjector
from inverse_audio_synthesis_tpu.models.vicreg import vicreg_loss as jvicreg_loss
from inverse_audio_synthesis_tpu.ops.pqmf import PQMF as JPQMF
from inverse_audio_synthesis_tpu_torch.models.audioembed import AudioEmbedding
from inverse_audio_synthesis_tpu_torch.models.jax_weights import (
    export_jax_variables,
    flatten,
    load_jax_variables,
)
from inverse_audio_synthesis_tpu_torch.models.layers import BatchNorm
from inverse_audio_synthesis_tpu_torch.models.mobilenetv3 import MobileNetV3Small, feature_map_size
from inverse_audio_synthesis_tpu_torch.models.paramembed import ParamEmbed
from inverse_audio_synthesis_tpu_torch.models.vicreg import Projector, vicreg_loss
from inverse_audio_synthesis_tpu_torch.ops.pqmf import PQMF

torch.set_num_threads(2)

GOLDEN = Path(__file__).parent / "golden" / "mobilenetv3_forward.npz"


def _rel(ref, got):
    return float(np.abs(ref - got).max() / np.abs(ref).max())


def _apply(module, variables, x, train):
    """JAX forward; in train mode also the mutated batch_stats."""
    if train:
        out, mutated = module.apply(variables, x, train=True, mutable=["batch_stats"])
        return np.asarray(out), jax.device_get(mutated)
    return np.asarray(module.apply(variables, x, train=False)), None


def _check_batch_stats(torch_module, jax_mutated, variables, tol):
    """Running statistics after one train-mode forward (flax's momentum convention
    and biased variance). Each BatchNorm folded (1 - m) * batch statistic into its
    running value; the running means are compared in units of (1 - m) * batch std,
    since a channel's batch mean can sit far below its spread."""
    got = flatten(export_jax_variables(torch_module, variables))
    ref = flatten({"batch_stats": jax_mutated["batch_stats"]})
    before = flatten({"batch_stats": variables["batch_stats"]})
    momentum = {
        "batch_stats/" + name.replace(".", "/"): m.momentum
        for name, m in torch_module.named_modules()
        if isinstance(m, BatchNorm)
    }
    for key in ref:
        if not key.endswith("/mean"):
            continue
        bn, var = key[: -len("/mean")], key[: -len("/mean")] + "/var"
        m = momentum[bn]
        batch_var = (ref[var] - m * before[var]) / (1.0 - m)
        unit = (1.0 - m) * np.sqrt(np.maximum(batch_var.max(), 0.0)) + 1e-12
        assert np.abs(got[key] - ref[key]).max() <= tol * unit, key
        np.testing.assert_allclose(got[var], ref[var], rtol=1e-5, atol=tol * (1.0 - m) * batch_var.max(), err_msg=var)


def test_pqmf_analysis_matches_jax():
    x = np.random.RandomState(0).randn(2, 1, 3 * 4096).astype(np.float32)
    jp, tp = JPQMF(n_bands=3), PQMF(n_bands=3)
    np.testing.assert_array_equal(tp.H.numpy(), jp.H)
    for channels_last in (False, True):
        ref = np.asarray(jp.analysis(jnp.asarray(x), channels_last=channels_last))
        got = tp.analysis(torch.from_numpy(x), channels_last=channels_last).numpy()
        assert got.shape == ref.shape
        # 63-tap float32 correlation, summed in another order: ~1e-6 of the signal
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_mobilenetv3_matches_golden_forward():
    """The committed golden activations (tests/test_precision_and_config.py), through
    the port's trunk with the JAX init's weights."""
    blob = np.load(GOLDEN)
    x = np.random.RandomState(int(blob["input_seed"])).rand(2, 64, 64, 3).astype(np.float32)
    model = JMobileNet()
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    trunk = MobileNetV3Small()
    load_jax_variables(trunk, jax.device_get(variables))
    trunk.eval()
    out = trunk(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).detach().numpy()
    out = out.transpose(0, 2, 3, 1)
    scale = np.abs(blob["out"]).max()
    # the golden test's own bound, scale-relative (random-init activations are ~1e-5)
    np.testing.assert_allclose(out / scale, blob["out"] / scale, atol=1e-4)
    assert feature_map_size(64, 64) == out.shape[1:3] and feature_map_size(240, 245) == (8, 8)


def test_mobilenetv3_train_mode_and_batch_stats():
    x = np.random.RandomState(4).rand(4, 48, 40, 3).astype(np.float32)
    model = JMobileNet()
    variables = jax.device_get(model.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False))
    ref, mutated = _apply(model, variables, jnp.asarray(x), train=True)
    trunk = MobileNetV3Small()
    load_jax_variables(trunk, variables)
    trunk.train()
    got = trunk(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).detach().numpy()
    # train-mode BatchNorm over a batch of 4 amplifies float32 rounding: measured 3e-5
    assert _rel(ref, got.transpose(0, 2, 3, 1)) < 1e-3
    _check_batch_stats(trunk, mutated, variables, tol=1e-3)


@pytest.mark.parametrize("train", [False, True])
def test_audio_embedding_matches_jax(train):
    audio = (np.random.RandomState(5).randn(4, 1, 3 * 64 * 64) * 0.3).astype(np.float32)
    jm = JAudioEmbedding(dim=32, image_size=(64, 64))
    variables = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.asarray(audio), train=False))
    ref, mutated = _apply(jm, variables, jnp.asarray(audio), train)
    tm = AudioEmbedding(dim=32, image_size=(64, 64))
    load_jax_variables(tm, variables)
    tm.train(train)
    got = tm(torch.from_numpy(audio)).detach().numpy()
    assert got.shape == ref.shape == (4, 32)
    # eval: measured 1.3e-6; train-mode BatchNorm on batch 4: measured 4e-5
    assert _rel(ref, got) < (1e-5 if not train else 1e-3)
    if train:
        _check_batch_stats(tm, mutated, variables, tol=1e-3)


@pytest.mark.parametrize("hidden_norm", ["nn.BatchNorm1d", "nn.Identity"])
def test_param_embed_matches_jax(hidden_norm):
    p = np.random.RandomState(6).rand(8, 78).astype(np.float32)
    jm = JParamEmbed(dim=32, hidden_norm=hidden_norm, dropout=0.0)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(3), jnp.asarray(p)))
    ref, mutated = _apply(jm, variables, jnp.asarray(p), train=True)
    tm = ParamEmbed(dim=32, hidden_norm=hidden_norm, dropout=0.0)
    load_jax_variables(tm, variables)
    tm.train()
    assert _rel(ref, tm(torch.from_numpy(p)).detach().numpy()) < 1e-5  # measured 2e-7
    if mutated.get("batch_stats"):
        _check_batch_stats(tm, mutated, variables, tol=1e-4)


def test_projector_matches_jax():
    z = np.random.RandomState(7).randn(8, 32).astype(np.float32)
    jm = JProjector((32, 64, 48, 64))
    variables = jax.device_get(jm.init(jax.random.PRNGKey(4), jnp.asarray(z)))
    ref, mutated = _apply(jm, variables, jnp.asarray(z), train=True)
    tm = Projector((32, 64, 48, 64))
    load_jax_variables(tm, variables)
    tm.train()
    assert _rel(ref, tm(torch.from_numpy(z)).detach().numpy()) < 1e-5  # measured 7e-8
    _check_batch_stats(tm, mutated, variables, tol=1e-4)
    tm.eval()  # eval mode reads the running statistics both sides just updated
    ref_eval, _ = _apply(jm, {**variables, **mutated}, jnp.asarray(z), train=False)
    assert _rel(ref_eval, tm(torch.from_numpy(z)).detach().numpy()) < 1e-5


def test_jax_weights_round_trip():
    z = np.zeros((2, 32), np.float32)
    jm = JProjector((32, 64, 64))
    variables = jax.device_get(jm.init(jax.random.PRNGKey(5), jnp.asarray(z)))
    tm = Projector((32, 64, 64))
    load_jax_variables(tm, variables)
    back = flatten(export_jax_variables(tm, variables))
    for key, value in flatten(variables).items():
        np.testing.assert_array_equal(back[key], value)
    bad = {"params": {"lin0": {"kernel": np.zeros((3, 3), np.float32)}}}
    with pytest.raises(ValueError):
        load_jax_variables(tm, bad)


@pytest.mark.parametrize(
    "cov_batch_size,bf16",
    [(None, False), (16, False), (None, True)],
)
def test_vicreg_loss_matches_jax(cov_batch_size, bf16):
    rng = np.random.RandomState(8)
    x = rng.randn(12, 96).astype(np.float32)
    y = (x + 0.3 * rng.randn(12, 96)).astype(np.float32)
    ref = jvicreg_loss(
        jnp.asarray(x), jnp.asarray(y), cov_batch_size=cov_batch_size,
        cov_operand_dtype=jnp.bfloat16 if bf16 else None,
    )
    got = vicreg_loss(
        torch.from_numpy(x), torch.from_numpy(y), cov_batch_size=cov_batch_size,
        cov_operand_dtype=torch.bfloat16 if bf16 else None,
    )
    # float32 reductions in another order; bf16 operands round the same way in both
    for r, g in zip(ref, got):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-5)
