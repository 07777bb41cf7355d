"""The HTS-AT pretraining job (``jobs/pretrain_htsat.py``) through the whole
harness on the CPU, at a tiny HTS-AT (8 mel bins stretched to a 32 x 32 image,
width 32, two stages: a grid of 8 in windows of 4, shifted on its second
block, then a grid of 4 in one window) on the tiny fixture's synth (0.33 s
voices, batch 8, float32), in a cell of its own written to a temporary
directory. Its limits are those of BENCHMARK.json's HTS-AT cell. A sound run
is correct; a step that leaves the state unchanged, takes the loss over half
the batch or gives the bias tables half their gradient is not; the control
fails the limits; a traced run reports ``mfu.train``; the FLOPs and the
window attention's bytes hold against counts by hand."""

import json

import pytest
import torch

from conftest import HERE, ROOT, load_run

CELL = "tiny-htsat.pretrain"
TINY_HTSAT = {"mel_bins": 8, "spec_size": 32, "embed_dim": 32, "depths": [2, 2], "num_heads": [2, 4],
              "window": 4}


def _tree():
    tree = json.loads((HERE / "fixtures" / "configs" / "tiny.json").read_text())["config"]
    tree["audio_tower"] = {"name": "htsat", "htsat": dict(TINY_HTSAT)}
    tree["vicreg"]["pretrained_vision_model"] = False
    return tree


@pytest.fixture
def htsat_cell(tmp_path, monkeypatch):
    """The harness pointed at a directory holding one tiny HTS-AT cell."""
    from portbench.core import spec

    bench = json.loads((HERE / "fixtures" / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny-htsat", "source": "x", "file": "configs/tiny-htsat.json", "reduced": [],
                         "why": "x"}]
    bench["workloads"] = [{"name": CELL, "config": "tiny-htsat", "traffic": "pretrain-htsat", "chips": 1,
                           "why": "x"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELL]
    limits = json.loads((ROOT / "portbench" / "cells" / "vicreg-htsat.pretrain-htsat-b64-k4.json").read_text())
    traffic = json.loads((ROOT / "portbench" / "traffic" / "pretrain-htsat-b64-k4.json").read_text())
    traffic.update(overrides={"vicreg.batch_size": 8}, log_every=10, profile_seconds=1.0)
    files = {"BENCHMARK.json": bench, "configs/tiny-htsat.json": {"source": "x", "reduced": [], "config": _tree()},
             "traffic/pretrain-htsat.json": traffic, f"cells/{CELL}.json": limits}
    for name, value in files.items():
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / name).write_text(json.dumps(value))
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    monkeypatch.setattr(spec, "DATA", tmp_path)
    return spec


@pytest.fixture
def run_htsat(htsat_cell, capsys):
    run = load_run()

    def go(seed: int = 3000000001, trace: int = 0, seconds: float = 1.0):
        rc = run.run(["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                     device="cpu")
        out, err = capsys.readouterr()
        assert rc == 0, err[-2000:]
        return json.loads(out.strip().splitlines()[-1]), err

    return go


def test_a_sound_htsat_run_is_correct(run_htsat):
    result, err = run_htsat()
    assert result["correct"] is True, err[-1500:]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {"setup_s", "train_voices_per_s"} <= set(result["metrics"])


@pytest.mark.parametrize("fault", ["unchanged_state", "half_loss"])
def test_a_broken_htsat_step_is_not_correct(run_htsat, fault):
    from portbench.faults import FAULTS

    with FAULTS[fault]():
        result, err = run_htsat()
    assert result["correct"] is False, err[-1500:]


def test_a_wrong_bias_table_gradient_is_not_correct(run_htsat, monkeypatch):
    """The program's relative-position bias tables take half their gradient,
    the forward unchanged: the worst table's first gradient reads 0.5 off the
    reference's, and the run is not correct."""
    from inverse_audio_synthesis_tpu_torch.models import htsat

    bias = htsat.WindowAttention.bias

    def half_gradient(self):
        b = bias(self)
        return 0.5 * b + 0.5 * b.detach()

    monkeypatch.setattr(htsat.WindowAttention, "bias", half_gradient)
    result, err = run_htsat()
    assert result["correct"] is False, err[-1500:]
    gap = float(err.split("check bias_grad_gap: ")[1].split()[0])
    assert gap == pytest.approx(0.5, rel=1e-3)


def test_the_control_fails_the_htsat_cells_limits(htsat_cell):
    c = htsat_cell.load_cell(CELL)
    job = htsat_cell.job_module(c.traffic["job"]).Job(c.config, c.traffic, 3000000001, "cpu")
    job.warmup()
    job.free()
    limits = c.limits["limits"]
    assert job.compare(job.program, job.reference(), limits).correct
    assert not job.compare(job.reference("fp8"), job.reference(), limits).correct


def test_a_traced_htsat_run_reports_mfu(run_htsat):
    result, _ = run_htsat(trace=1)
    assert 0 < result["metrics"]["mfu.train"]["value"] < 100
    assert "winattn_roofline.train" not in result["metrics"]  # the CPU launches no fused attention kernel


def test_htsat_flops_by_hand():
    """The step's model FLOPs: every Linear and Conv of the encoder, the
    parameter tower and the projector twice, forward and backward (the patch
    convolution's input gradient too: ``bn0`` trains), the covariance term's
    Gram products, and the window attention's products, 3 x 4 N^2 C a window
    and layer."""
    from portbench.counts import htsat_flops, window_attention
    from portbench.reference import ast as A
    from portbench.reference import htsat as H

    tree = _tree()
    b, d, dim = tree["vicreg"]["batch_size"], tree["embeddim"], tree["dim"]
    # stage 1: 64 tokens at width 32 in 4 windows of 16; stage 2: 16 tokens at 64, one window
    blocks = 2 * 64 * (12 * 32 * 32) * 2 + 2 * 16 * (12 * 64 * 64) * 2
    merge = 2 * 16 * (4 * 32) * 64
    patches = 2 * 64 * 32 * 16
    encoder = b * (blocks + merge + patches + 2 * 64 * dim)
    attn = b * (2 * 4 * 4 * 16 * 16 * 32 + 2 * 1 * 4 * 16 * 16 * 64)
    assert window_attention.flops_per_voice(tree) * b == 3 * attn
    param = 2 * b * (78 * dim + 2 * dim * dim)
    proj = 2 * b * (dim * 64 + 64 * d)
    gram = 2 * b * b * d
    first = 2 * b * 78 * dim  # the parameter tower's first input gradient is not taken
    forward = encoder + attn + param + 2 * proj + 2 * gram
    backward = 2 * (encoder + param + 2 * proj) - first + 2 * attn + 2 * 2 * gram
    assert htsat_flops.pretrain_step(tree) == forward + backward
    with torch.device("meta"):
        names = A.layer_norm_scales(H.VICReg(tree))
    assert len(names) == 1 + 2 * 4 + 1 + 1  # patch embed, two a block, one merge, the last norm


def test_window_attention_bytes_by_hand():
    """24 C bytes a token and layer (bf16 q, k, v, o read or written in the
    forward; q, k, v, o, dO read and dQ, dK, dV written in the backward), the
    float32 bias tables once a step, and two kernels a layer; at HTSAT-base,
    32 FLOP a byte."""
    from portbench.counts import window_attention as wa

    tree = _tree()
    assert wa.bytes_per_voice(tree) == 2 * 64 * 24 * 32 + 2 * 16 * 24 * 64
    assert wa.table_bytes_per_step(tree) == 2 * 49 * 2 * 4 + 2 * 49 * 4 * 4
    assert wa.launches_per_step(tree) == 2 * 4
    base = json.loads((ROOT / "portbench" / "configs" / "vicreg-htsat.json").read_text())["config"]
    assert [s[0] for s in wa.stages(base)] == [64, 32, 16, 8]
    assert wa.flops_per_voice(base) / wa.bytes_per_voice(base) == 32.0
    assert wa.launches_per_step(base) == 36
    assert wa.is_attention_kernel("fmha_cutlassB_bf16_aligned_64x64_k32_seqaligned_sm80(...)")
    assert not wa.is_attention_kernel("cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma")
