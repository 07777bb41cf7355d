"""The port's torchvision trunk import against the JAX package's.

- The converted tree of a synthetic torchvision state dict
  (``tests/test_torch_import.py:synthetic_torchvision_state_dict``), leaf for leaf.
- The trunk loaded into the audio tower, forward against the JAX tower with the
  same weights.
- ``vicreg.vision_weights_path`` through the config, with the committed fixture
  pickle and with a raw ``torch.save`` state dict: the trunk equals the file, the
  param tower keeps its init, one step is finite.
"""

import logging
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_overrides
from inverse_audio_synthesis_tpu.models import torch_import as jimport
from inverse_audio_synthesis_tpu.models.audioembed import AudioEmbedding as JAudioEmbedding
from inverse_audio_synthesis_tpu_torch.models import torch_import
from inverse_audio_synthesis_tpu_torch.models.audioembed import AudioEmbedding
from inverse_audio_synthesis_tpu_torch.models.jax_weights import (
    export_jax_variables,
    flatten,
    load_jax_variables,
)
from inverse_audio_synthesis_tpu_torch.train import pretrain
from inverse_audio_synthesis_tpu_torch.utils.config import load_config
from test_torch_import import synthetic_torchvision_state_dict

torch.set_num_threads(2)

FIXTURE = Path(__file__).parent / "golden" / "vision_trunk_fixture.pkl"
TINY = tiny_overrides(**{"param_embed.dropout": 0})


def _state_dict():
    """The synthetic torchvision state dict with positive running variances, so a
    forward through it is finite."""
    sd = synthetic_torchvision_state_dict()
    return {k: (np.abs(v) + 0.5 if k.endswith("running_var") else v) for k, v in sd.items()}


def _trunk_tree(model, converted):
    params, stats = converted
    return flatten(export_jax_variables(model.backbone_audio.vision_model,
                                        {"params": params, "batch_stats": stats}))


def test_converted_tree_matches_jax():
    sd = _state_dict()
    want = flatten(dict(zip(("params", "batch_stats"), jimport.convert_mobilenetv3_small_state_dict(sd))))
    got = flatten(dict(zip(("params", "batch_stats"),
                           torch_import.convert_mobilenetv3_small_state_dict(
                               {k: torch.from_numpy(v) for k, v in sd.items()}))))
    assert sorted(got) == sorted(want) and len(got) > 100
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_trunk_loaded_into_audio_embedding_matches_jax():
    """JAX ``load_into_audio_embedding`` + apply against the port's, on the same
    tower weights and the same converted trunk; eval mode, at the port's tower
    bound (tests/test_torch_port_models.py)."""
    converted = jimport.convert_mobilenetv3_small_state_dict(_state_dict())
    audio = (np.random.RandomState(5).randn(3, 1, 3 * 64 * 64) * 0.3).astype(np.float32)
    jm = JAudioEmbedding(dim=32, image_size=(64, 64))
    variables = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.asarray(audio), train=False))
    ref = np.asarray(jm.apply(jimport.load_into_audio_embedding(variables, converted),
                              jnp.asarray(audio), train=False))
    tm = AudioEmbedding(dim=32, image_size=(64, 64))
    load_jax_variables(tm, variables)
    torch_import.load_into_audio_embedding(tm, converted, prefix=("vision_model",))
    tm.eval()
    got = tm(torch.from_numpy(audio)).detach().numpy()
    assert np.isfinite(ref).all() and got.shape == ref.shape == (3, 32)
    assert float(np.abs(ref - got).max() / np.abs(ref).max()) < 1e-5


def test_load_refuses_a_tree_that_does_not_fit():
    params, stats = torch_import.convert_mobilenetv3_small_state_dict(_state_dict())
    tm = AudioEmbedding(dim=32, image_size=(64, 64))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    short = {k: v for k, v in params.items() if k != "head"}
    with pytest.raises(ValueError, match="missing"):
        torch_import.load_into_audio_embedding(tm, (short, stats), prefix=("vision_model",))
    wrong = pickle.loads(pickle.dumps(params))
    wrong["stem"]["conv"]["kernel"] = wrong["stem"]["conv"]["kernel"][:, :, :, :8]
    with pytest.raises(ValueError, match="shapes differ"):
        torch_import.load_into_audio_embedding(tm, (wrong, stats), prefix=("vision_model",))
    for k, v in tm.state_dict().items():  # nothing was loaded
        assert torch.equal(v, before[k]), k


def _file_forms(tmp_path):
    """(name, path, the converted tree the file holds) of both file forms."""
    with open(FIXTURE, "rb") as f:
        blob = pickle.load(f)
    sd = _state_dict()
    raw = tmp_path / "mobilenet_v3_small_features.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(raw))
    return [("fixture pickle", FIXTURE, (blob["params"], blob["batch_stats"])),
            ("raw state dict", raw, jimport.convert_mobilenetv3_small_state_dict(sd))]


def test_vision_weights_path_through_the_config(tmp_path):
    base = pretrain.VicregPretrainTask(load_config(overrides=TINY + ["platform=cpu"])).init_state()
    for name, path, converted in _file_forms(tmp_path):
        np.testing.assert_array_equal(
            flatten(dict(zip(("params", "batch_stats"), torch_import.load_vision_weights_file(str(path)))))[
                "params/stem/conv/kernel"], converted[0]["stem"]["conv"]["kernel"])
        task = pretrain.VicregPretrainTask(load_config(
            overrides=TINY + ["platform=cpu", f"vicreg.vision_weights_path={path}"]))
        state = task.init_state()
        got, want = _trunk_tree(state.model, converted), flatten(
            {"params": converted[0], "batch_stats": converted[1]})
        assert sorted(got) == sorted(want), name
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32), err_msg=f"{name} {k}")
        for (k, a), b in zip(base.model.backbone_param.state_dict().items(),
                             state.model.backbone_param.state_dict().values()):
            assert torch.equal(a, b), f"{name}: the param tower changed at {k}"
        state, metrics = task.train_step(state, 0)
        assert np.isfinite(float(metrics["vicreg/train/loss"])), name


def test_converter_cli_writes_the_pickle_both_packages_read(tmp_path):
    sd = _state_dict()
    src, dst = tmp_path / "in.pt", tmp_path / "out.pkl"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(src))
    assert torch_import.main([str(src), str(dst)]) == 0
    ours = flatten(dict(zip(("params", "batch_stats"), torch_import.load_vision_weights_file(str(dst)))))
    theirs = flatten(dict(zip(("params", "batch_stats"), jimport.load_vision_weights_file(str(dst)))))
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_random_init_warning_once_per_process(monkeypatch, caplog):
    monkeypatch.setattr(pretrain, "_WARNED_RANDOM_INIT", False)
    cfg = load_config(overrides=TINY + ["platform=cpu", "vicreg.pretrained_vision_model=true"])
    with caplog.at_level(logging.WARNING, logger=pretrain.__name__):
        for _ in range(2):
            pretrain.VicregPretrainTask(cfg).init_state()
    assert sum("random-init" in r.getMessage() for r in caplog.records) == 1
