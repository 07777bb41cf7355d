"""The AST pretraining job (``jobs/pretrain_ast.py``) through the whole harness
on the CPU, at a tiny AST (width 64, 2 blocks, 4 heads, 32 mel bins, 40
frames: 8 tokens) on the tiny fixture's synth (0.33 s voices, batch 8,
float32), in a cell of its own written to a temporary directory. Its limits
are those of BENCHMARK.json's AST cell. A sound run is correct; a step that
leaves the state unchanged or takes the loss over half the batch is not; the
control fails the limits; a traced run reports ``mfu.train``; the AST FLOPs
count holds against a count by hand."""

import json

import pytest
import torch

from conftest import HERE, ROOT, load_run

CELL = "tiny-ast.pretrain"
TINY_AST = {"input_fdim": 32, "input_tdim": 40, "frame_length_ms": 25.0, "frame_shift_ms": 10.0,
            "patch_size": 16, "fstride": 10, "tstride": 10, "embed_dim": 64, "depth": 2, "num_heads": 4,
            "mlp_dim": 256, "norm_mean": -4.2677393, "norm_std": 4.5689974}


def _tree():
    tree = json.loads((HERE / "fixtures" / "configs" / "tiny.json").read_text())["config"]
    tree["audio_tower"] = {"name": "ast", "ast": dict(TINY_AST)}
    tree["vicreg"]["pretrained_vision_model"] = False
    return tree


@pytest.fixture
def ast_cell(tmp_path, monkeypatch):
    """The harness pointed at a directory holding one tiny AST cell."""
    from portbench.core import spec

    bench = json.loads((HERE / "fixtures" / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny-ast", "source": "x", "file": "configs/tiny-ast.json", "reduced": [],
                         "why": "x"}]
    bench["workloads"] = [{"name": CELL, "config": "tiny-ast", "traffic": "pretrain-ast", "chips": 1, "why": "x"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELL]
    limits = json.loads((ROOT / "portbench" / "cells" / "vicreg-ast.pretrain-b64-k4.json").read_text())
    traffic = json.loads((ROOT / "portbench" / "traffic" / "pretrain-b64-k4.json").read_text())
    traffic.update(overrides={"vicreg.batch_size": 8}, log_every=10, profile_seconds=1.0)
    files = {"BENCHMARK.json": bench, "configs/tiny-ast.json": {"source": "x", "reduced": [], "config": _tree()},
             "traffic/pretrain-ast.json": traffic, f"cells/{CELL}.json": limits}
    for name, value in files.items():
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / name).write_text(json.dumps(value))
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    monkeypatch.setattr(spec, "DATA", tmp_path)
    return spec


@pytest.fixture
def run_ast(ast_cell, capsys):
    run = load_run()

    def go(seed: int = 3000000001, trace: int = 0, seconds: float = 1.0):
        rc = run.run(["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                     device="cpu")
        out, err = capsys.readouterr()
        assert rc == 0, err[-2000:]
        return json.loads(out.strip().splitlines()[-1]), err

    return go


def test_a_sound_ast_run_is_correct(run_ast):
    result, err = run_ast()
    assert result["correct"] is True, err[-1500:]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {"setup_s", "train_voices_per_s"} <= set(result["metrics"])


@pytest.mark.parametrize("fault", ["unchanged_state", "half_loss"])
def test_a_broken_ast_step_is_not_correct(run_ast, fault):
    from portbench.faults import FAULTS

    with FAULTS[fault]():
        result, err = run_ast()
    assert result["correct"] is False, err[-1500:]


def test_the_control_fails_the_ast_cells_limits(ast_cell):
    c = ast_cell.load_cell(CELL)
    job = ast_cell.job_module(c.traffic["job"]).Job(c.config, c.traffic, 3000000001, "cpu")
    job.warmup()
    job.free()
    limits = c.limits["limits"]
    assert job.compare(job.program, job.reference(), limits).correct
    assert not job.compare(job.reference("fp8"), job.reference(), limits).correct


def test_a_traced_ast_run_reports_mfu(run_ast):
    result, _ = run_ast(trace=1)
    assert 0 < result["metrics"]["mfu.train"]["value"] < 100
    assert "attn_roofline.train" not in result["metrics"]  # the CPU launches no fused attention kernel


def test_ast_flops_by_hand():
    """The step's model FLOPs: every Linear and Conv of the encoder, the
    parameter tower and the projector twice, forward and backward, the
    covariance products, and attention's products, 3 x 4 N^2 D a layer."""
    from portbench.counts import ast_flops, attention
    from portbench.reference import ast as A

    tree = _tree()
    b, a, d = tree["vicreg"]["batch_size"], TINY_AST, tree["embeddim"]
    n = attention.tokens(tree)
    assert n == 2 + 2 * 3
    grid = n - 2
    dim, e = tree["dim"], a["embed_dim"]
    block = 2 * n * (e * 3 * e + e * e + 2 * e * a["mlp_dim"])
    patches = 2 * grid * e * 16 * 16
    encoder = b * (a["depth"] * block + patches + 2 * e * dim)
    attn = b * a["depth"] * 4 * n * n * e
    assert attention.flops_per_voice(tree) * b == 3 * attn
    param = 2 * b * (78 * dim + 2 * dim * dim)
    proj = 2 * b * (dim * 64 + 64 * d)
    cov = 2 * (2 * d * d * b)
    first = b * patches + 2 * b * 78 * dim  # the first layers' input gradients are not taken
    forward = encoder + attn + param + 2 * proj + cov
    backward = 2 * (encoder + param + 2 * proj) - first + 2 * attn + 2 * cov
    assert ast_flops.pretrain_step(tree) == forward + backward
    with torch.device("meta"):
        names = A.layer_norm_scales(A.VICReg(tree))
    assert len(names) == 2 * a["depth"] + 2
