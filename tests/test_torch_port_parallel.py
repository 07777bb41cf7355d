"""The port's data and tensor parallelism against one rank, on the CPU over gloo.

Each world is spawned with ``parallel/launch.py:spawn_world`` (a file rendezvous
in a fresh directory: no port) and runs the runs of ``parallel/jobs.py``, which
one process also makes without a process group; the two are held against each
other with the tolerances of ``tests/test_cross_mesh.py``. The config is the
tiny one of ``tests/conftest.py`` with a 60 x 80 pseudo-image (14,400 samples,
ratio 100), so that the fused render's plain version is on the path, and with
``param_embed.dropout`` left at 0.1: the global mask does not depend on the mesh.

Worlds: W=2 as (2, 1) and W=4 as (2, 2), and (1, 2) for the collectives and the
rejected step. The gradients the optimizer receives are compared too: LARS
normalizes each update by ``||g||``, so a gradient W times too large would
otherwise pass.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from inverse_audio_synthesis_tpu_torch.parallel import jobs
from inverse_audio_synthesis_tpu_torch.parallel.launch import spawn_world

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
# tests/conftest.py:tiny_overrides with the 60 x 80 image, written out: this file
# imports nothing of JAX
BASE = [
    "vicreg=fast", "dim=32", "embeddim=64", "vicreg.mlp='64-%d'", "vicreg.batch_size=8",
    "image.height=60", "image.width=80", f"torchsynth.buffer_size_seconds={14400 / 44100}",
    "precision=f32", "param_embed.dropout=0.1", "platform=cpu",
]
# tests/test_cross_mesh.py:142-151: three-term combined objective, mel term chunked
DOWNSTREAM = [
    "audio_to_params.batch_size=8", "audio_to_params.dropout=0.0", "audio_to_params.loss=combined",
    "audio_to_params.loss_weights.param_mse=1.0", "audio_to_params.loss_weights.embedding=1.0",
    "audio_to_params.loss_weights.mel_l1=0.25", "audio_to_params.mel_chunk=4",
]
MESHES = {"2x1": (2, 1), "2x2": (2, 2)}
METRIC_TOL = dict(rtol=2e-4, atol=1e-5)


def _mesh(data, model):
    return BASE + DOWNSTREAM + [f"mesh.data={data}", f"mesh.model={model}"]


def _calls(data, model, ckpt_dir):
    over = _mesh(data, model)
    calls = [
        ("pretrain", dict(overrides=over)),
        ("downstream", dict(overrides=over)),
        ("retrieval", dict(overrides=over, linear_embedding=True)),
    ]
    if (data, model) == (2, 1):
        calls += [
            ("collectives", dict(meshes=((2, 1), (1, 2)))),
            ("rejected_step", dict(overrides=_mesh(1, 2), nan_rank=1)),
            ("preempted", dict(overrides=over, directory=str(ckpt_dir / "signal"), signal_rank=1)),
        ]
    else:  # the one-rank checkpoint restored here, then this world's own written
        calls += [
            ("checkpoint", dict(overrides=over, directory=str(ckpt_dir / "w1"), save=False)),
            ("checkpoint", dict(overrides=over, directory=str(ckpt_dir / "w4"), save=True)),
        ]
    return calls


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("ckpt")


@pytest.fixture(scope="module")
def one_rank(ckpt_dir):
    """The same runs in this process, with no process group."""
    over = _mesh(-1, 1)
    return {
        "pretrain": jobs.pretrain(over, keep_init=True),
        "downstream": jobs.downstream(over, keep_init=True),
        "retrieval": jobs.retrieval(over, linear_embedding=True),
        "collectives": jobs.collectives(((1, 1),))[0],
        "checkpoint": jobs.checkpoint(over, str(ckpt_dir / "w1"), save=True),
    }


@pytest.fixture(scope="module")
def worlds(one_rank, ckpt_dir):
    """{mesh id: [per call: [per rank: result]]}; the W=1 checkpoint exists first."""
    out = {}
    for name, (data, model) in MESHES.items():
        per_rank = spawn_world(data * model, jobs.run_all, (_calls(data, model, ckpt_dir),),
                               platform="cpu", timeout=300)
        out[name] = [list(r) for r in zip(*per_rank)]
    return out


def _assert_params(ref, got, init, label):
    """tests/test_cross_mesh.py:assert_params_equivalent, per tensor."""
    for k in ref:
        a, b, p0 = (t.double() for t in (ref[k], got[k], init[k]))
        delta = float((a - b).abs().max())
        limit = max(4e-6, (0.05 if a.dim() >= 2 else 0.25) * float((a - p0).abs().max()))
        assert delta <= limit, f"{label} {k}: delta {delta:.3e} exceeds {limit:.3e}"


def _assert_grads(ref, got, label):
    """The whole gradient's norm within 1% (a factor of W would show as 100% or
    more; the downstream step's grad-through-synth term measured 0.12% at W=2),
    and each tensor within 5% of its norm (a bias fed into a BatchNorm has a zero
    gradient in exact arithmetic and carries rounding noise only: measured 5e-5,
    below 1e-4 of the largest norm)."""
    norm = lambda d: float(torch.sqrt(sum(torch.sum(v.double() ** 2) for v in d.values())))
    assert abs(norm(got) / norm(ref) - 1.0) < 1e-2, label
    floor = 1e-4 * max(float(v.norm()) for v in ref.values())
    for k in ref:
        err, scale = float((got[k] - ref[k]).norm()), float(ref[k].norm())
        assert err <= 0.05 * scale + floor, f"{label} gradient {k}: {err:.3e} of {scale:.3e}"


def _assert_metrics(ref, got, label):
    for k, v in ref.items():
        if isinstance(v, torch.Tensor):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), **METRIC_TOL, err_msg=f"{label} {k}")
        else:
            np.testing.assert_allclose(got[k], v, **METRIC_TOL, err_msg=f"{label} {k}")


def _replicas_agree(results, model):
    """Ranks of one model index hold the same parameters (per-tensor sums)."""
    for r in results:
        assert r["digest"] == results[r["rank"] % model]["digest"], r["rank"]


def test_collectives_match_one_process(one_rank, worlds):
    """gather_rows is exact and its backward keeps the rank's slot; BatchNorm on
    the data group's rows equals BatchNorm on the whole batch (running
    statistics included); the projector with the Megatron pair equals the dense
    one, input and parameter gradients included."""
    ref = one_rank["collectives"]
    for mesh_idx, (data, model) in enumerate(((2, 1), (1, 2))):
        for res in worlds["2x1"][3]:
            got = res[mesh_idx]
            rows = slice(*got["rows"])
            label = f"mesh ({data},{model}) rank {got['rows']}"
            assert torch.equal(got["gathered"], ref["gathered"]), label
            assert torch.equal(got["gather_grad"], ref["gather_grad"][rows]), label
            for k in ("bn_out", "bn_grad_x", "proj_grad_x"):
                torch.testing.assert_close(got[k], ref[k][rows], rtol=1e-5, atol=1e-5, msg=label + k)
            torch.testing.assert_close(got["proj_out"], ref["proj_out"], rtol=1e-5, atol=1e-5)
            for a, b in zip(got["bn_grads"], ref["bn_grads"]):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
            for k in ("running_mean", "running_var"):
                torch.testing.assert_close(got["bn_running"][f"0.{k}"], ref["bn_running"][f"0.{k}"],
                                           rtol=1e-6, atol=1e-6)
            for k, g in ref["proj_grads"].items():
                torch.testing.assert_close(got["proj_grads"][k], g, rtol=1e-4, atol=1e-4, msg=label + k)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_pretrain_step_matches_one_rank(one_rank, worlds, mesh):
    """One VICReg train step (dropout 0.1) and a val step: the global metrics on
    every rank, the reduced gradient and the updated parameters."""
    ref, res = one_rank["pretrain"], worlds[mesh][0]
    for r in res:
        _assert_metrics(ref["metrics"][0], r["metrics"][0], f"{mesh} rank {r['rank']}")
        _assert_metrics(ref["val"], r["val"], f"{mesh} rank {r['rank']} val")
    _assert_grads(ref["grads"], res[0]["grads"], mesh)
    _assert_params(ref["params"], res[0]["params"], ref["init"], mesh)
    _replicas_agree(res, MESHES[mesh][1])
    assert all(r["all_reduce_per_step"]["calls"] > 0 for r in res)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_downstream_step_matches_one_rank(one_rank, worlds, mesh):
    """A test step, one combined step (mel term in global chunks of 4 rows) and
    a test step again: metrics, per-parameter MAE vectors, gradient and head
    parameters."""
    ref, res = one_rank["downstream"], worlds[mesh][1]
    for r in res:
        _assert_metrics(ref["metrics"], r["metrics"], f"{mesh} rank {r['rank']}")
        _assert_metrics(ref["test_init"], r["test_init"], f"{mesh} rank {r['rank']} test before")
        _assert_metrics(ref["test"], r["test"], f"{mesh} rank {r['rank']} test")
    _assert_grads(ref["grads"], res[0]["grads"], mesh)
    _assert_params(ref["params"], res[0]["params"], ref["init"], mesh)
    _replicas_agree(res, MESHES[mesh][1])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_retrieval_chunk_steps_match_one_rank(one_rank, worlds, mesh):
    """Two candidate batches of 8 in sub-chunks of 4, split over the data group:
    the same distances and the same retrieved candidates on every rank."""
    ref = one_rank["retrieval"]
    for r in worlds[mesh][2]:
        np.testing.assert_allclose(r["best_dist"].numpy(), ref["best_dist"].numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["best_params"].numpy(), ref["best_params"].numpy(), rtol=1e-5, atol=1e-6)
        assert torch.equal(r["best_audio"], ref["best_audio"])  # sub-chunks render at one size


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("task", ["pretrain", "downstream"])
def test_render_rows_keyed_by_global_position(one_rank, worlds, mesh, task):
    """Each rank's noise rows are the one-rank buffer's rows at their global
    positions, bit for bit; K1's audio and K2's cotangents of its rows agree with
    the one-rank rows. (On the CPU the control-rate torch.pow rounds the tail of
    a vectorized loop differently at another batch size, so these are held at
    1e-4 here; the card holds them bit for bit, chip_smoke.py.)"""
    ref = one_rank[task]["kernels"]
    for r in worlds[mesh][0 if task == "pretrain" else 1]:
        rows = slice(*r["rows"])
        got = r["kernels"]
        assert torch.equal(got["noise_row_sums"], ref["noise_row_sums"][rows])
        for k in ("audio", "d_routed", "d_scalars"):
            scale = float(ref[k][rows].abs().max())
            assert float((got[k] - ref[k][rows]).abs().max()) <= 1e-4 * scale, (mesh, k)


def test_nan_on_one_rank_rejects_the_step_on_all(worlds):
    """A NaN gradient on rank 1 of a (1, 2) mesh (no data group to spread it):
    both ranks agree on the flag, apply nothing and count the rejection."""
    res = worlds["2x1"][4]
    assert [r["rank"] for r in res] == [0, 1]
    for r in res:
        assert not r["changed"] and r["count"] == 0 and r["total_notfinite"] == 1, r


def test_a_signal_on_one_rank_stops_every_rank_at_one_step(worlds):
    """SIGTERM reaches rank 1 alone during step 1 of Trainer.fit: both ranks stop
    after that step, report the signal, and rank 0 writes the checkpoint of step 1."""
    res = worlds["2x1"][5]
    for r in res:
        assert (r["step"], r["interrupted"], r["saved"]) == (1, int(signal.SIGTERM), 1), r


def test_checkpoint_written_at_w1_restores_at_w4(one_rank, worlds):
    saved = one_rank["checkpoint"]
    for r in worlds["2x2"][3]:
        assert r["step"] == 1 and r["count"] == 1
    restored = worlds["2x2"][3][0]["params"]
    assert all(torch.equal(restored[k], v) for k, v in saved["params"].items())
    _replicas_agree(worlds["2x2"][3], 2)


def test_checkpoint_written_at_w4_restores_at_w1(worlds, ckpt_dir):
    saved = worlds["2x2"][4][0]["params"]
    restored = jobs.checkpoint(_mesh(-1, 1), str(ckpt_dir / "w4"), save=False)
    assert restored["step"] == 1 and restored["count"] == 1
    assert all(torch.equal(restored["params"][k], v) for k, v in saved.items())


def test_cli_under_torchrun_on_two_cpu_ranks(tmp_path):
    """``torchrun --standalone`` (a free port) with mesh.data=2 platform=cpu: two
    ranks train two steps, rank 0 alone logs and writes the checkpoint."""
    args = BASE + ["mesh.data=2", "vicreg.limit_train_batches=2", "log_every=1",
                   f"run_dir={tmp_path}", "num_batches=100"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "inverse_audio_synthesis_tpu_torch.pretrain", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "backend gloo" in proc.stdout and proc.stdout.count("checkpoints under") == 1
    assert (tmp_path / "checkpoints" / "vicreg" / "last").read_text() == "step_000000000002"
    metrics = list(tmp_path.glob("pretrain-torch-*/metrics.jsonl"))
    # the vendored clip's PQMF filter range, then one line per train step
    lines = metrics[0].read_text().splitlines() if len(metrics) == 1 else []
    assert len(lines) == 3 and '"pqmf/band0/min"' in lines[0], lines


def test_backend_choice(monkeypatch):
    """NCCL when every local rank has a card of its own, gloo when ranks share
    one or run on the CPU; no card and no platform=cpu raises."""
    from inverse_audio_synthesis_tpu_torch.parallel.launch import choose_backend, init_from_env
    from inverse_audio_synthesis_tpu_torch.utils.config import load_config

    assert choose_backend("cpu", 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert choose_backend(None, 2) == "nccl"
    assert choose_backend(None, 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="platform=cpu"):
        choose_backend(None, 1)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_from_env(load_config(overrides=["platform=cpu"])) is None  # one rank, no group


def test_mesh_without_a_group_is_one_rank():
    from inverse_audio_synthesis_tpu_torch.parallel.mesh import create_mesh, split_dim

    mesh = create_mesh(-1, 1)
    assert (mesh.data, mesh.model, mesh.distributed, mesh.local_rows(8)) == (1, 1, False, slice(0, 8))
    for data, model in ((2, 1), (1, 2), (3, 3)):
        with pytest.raises(ValueError, match="but the process group has 1"):
            create_mesh(data, model)
    # the projector layout of the JAX package's _projector_spec, in torch's [out, in]
    assert [split_dim(f"projector.{n}") for n in ("lin0.weight", "lin1.bias", "bn0.running_var",
                                                   "lin_final.weight")] == [0, 0, 0, 1]
    assert split_dim("backbone_param.block1.lin.weight") is None
