"""Every job's units run at a tiny size on the CPU through the whole harness
(set-up, window, the reference's judgement), sound runs come out correct, and
a run with the timed path broken underneath (``portbench/faults.py``) comes
out not correct: a step that leaves the state unchanged, half of the batch
left out with the mean taken over the rest (with the shapes cut, and with every
shape kept), the head's backward broken. The control (the reference in float8
in the program's place) fails the cell's limits."""


import pytest
import torch


TRAINING = ("tiny.pretrain", "tiny.combined", "tiny.embedding")


@pytest.mark.parametrize("cell", TRAINING)
def test_a_sound_run_is_correct(run_cell, cell):
    result, err = run_cell(cell)
    assert result["correct"] is True, err[-1500:]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert "setup_s" in result["metrics"] and len(result["metrics"]) >= 2
    assert list(result)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check ")


def test_traced_run_reports_per_layer_metrics(run_cell):
    result, _ = run_cell("tiny.pretrain", trace=1)
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "mfu.train" in result["metrics"] and 0 < result["metrics"]["mfu.train"]["value"] < 100


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "half_loss"])
@pytest.mark.parametrize("cell", TRAINING)
def test_a_broken_training_step_is_not_correct(run_cell, cell, fault):
    from portbench.faults import FAULTS

    with FAULTS[fault]():
        result, err = run_cell(cell)
    assert result["correct"] is False, err[-1500:]


def test_a_broken_head_backward_is_not_correct(run_cell):
    """A fault in the head's backward alone: only the head's gradient from the
    program's own gradient at its predictions sees it."""
    from portbench.faults import FAULTS

    with FAULTS["flipped_head_grad"]():
        result, err = run_cell("tiny.combined")
    assert result["correct"] is False, err[-1500:]
    checks = result["checks"]
    assert checks["head_grad_gap"]["value"] > checks["head_grad_gap"]["limit"]
    assert all(v["value"] <= v["limit"] for k, v in checks.items() if k != "head_grad_gap"), checks


def test_the_traced_part_continues_the_window_fit(run_cell, monkeypatch):
    """The profiled steps continue the window's one ``Trainer.fit``: a traced
    run starts no more fits than an untraced one."""
    from inverse_audio_synthesis_tpu_torch.train.loop import Trainer

    fits = []
    original = Trainer.fit
    monkeypatch.setattr(Trainer, "fit", lambda self, *a, **k: fits.append(1) or original(self, *a, **k))
    counts = []
    for trace in (0, 1):
        fits.clear()
        result, _ = run_cell("tiny.pretrain", trace=trace, seconds=2.0)
        counts.append(len(fits))
    assert counts[0] == counts[1]
    assert "mfu.train" in result["metrics"]


@pytest.mark.parametrize("cell", TRAINING)
def test_the_control_fails_the_cells_limits(tiny, cell):
    """The reference in float8 in the program's place, judged by the cell's
    limits (the fixture cells hold those of BENCHMARK.json's cells that run the
    same job: portbench/cells/)."""
    from portbench.core import spec

    c = spec.load_cell(cell)
    job = spec.job_module(c.traffic["job"]).Job(c.config, c.traffic, 3000000001, "cpu")
    job.warmup()
    job.free()
    limits = c.limits["limits"]
    assert job.compare(job.program, job.reference(), limits).correct
    assert not job.compare(job.reference("fp8"), job.reference(), limits).correct
