"""VICReg pretraining: ``Trainer.fit`` drives ``VicregPretrainTask`` on
consecutive batch numbers.

Traffic parameters: ``steps_per_dispatch`` (the loop's dispatch length: on the
card one CUDA graph of that many steps, replayed), ``log_every`` (the loop's log
cadence, where the host reads the metrics), ``check_steps`` (the first steps,
taken in set-up through the same loop, that the reference follows),
``profile_seconds``.

Set-up builds the task and its state, loads the benchmark's weights, takes the
check steps through ``Trainer.fit`` (recording each step's loss and terms, the
projector's first outputs, the first gradient the optimizer receives and the
change of every parameter; the graph of ``steps_per_dispatch`` steps is
captured there), then warms up with a fit whose dispatches are one eager step
and a graph of the shorter length the log boundaries clamp to. The window is
one ``Trainer.fit`` on the same task and state (``_common.fit_for``), which
starts where its dispatches are those of a fit running since step 0: one eager
step, then graphs of those two lengths only.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.core import check as C
from portbench.core import weights as W
from portbench.jobs import _common
from portbench.reference import strict
from portbench.reference import towers as T
from portbench.reference import train as RT

LOSS = "vicreg/train/loss"
COMPONENTS = ("repr_loss", "std_loss", "cov_loss")  # invariance, variance, covariance terms


class Job:
    def __init__(self, tree, traffic, seed: int, device):
        from inverse_audio_synthesis_tpu_torch.train.loop import Trainer
        from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask

        self.tree, self.traffic, self.seed, self.device = tree, traffic, int(seed), torch.device(device)
        self.cfg = _common.program_config(tree, traffic, seed, device)
        self.batch = int(self.cfg.vicreg.batch_size)
        self.chunk = int(traffic["log_every"])
        self.check_steps = int(traffic["check_steps"])
        self.start = _common.first_batch_number(seed)
        self.task = VicregPretrainTask(self.cfg)
        self.state = self.task.init_state()
        weights = self._weights()
        W.load_into(self.state.model, weights)
        split = _common.ConsecutiveSplit(self.start)

        def trainer(task):
            return Trainer(task, split, log_every=self.chunk, detect_anomaly=False,
                           steps_per_dispatch=int(traffic["steps_per_dispatch"]))

        self.trainer = trainer(self.task)
        # the first steps, through the window's own loop
        names = [n for n, _ in self.state.model.named_parameters()]
        recording = _common.RecordingTask(self.task, {"loss": LOSS, **{c: f"vicreg/train/{c}" for c in COMPONENTS}})
        grads = _common.record_first_gradient(self.state.optimizer, names)
        embed = _common.record_first_output(self.state.model.projector, calls=2)  # x, then y
        first = trainer(recording)
        first.limit_train_batches = self.check_steps
        self.state = first.fit(self.state, 0)
        self.program = {
            **recording.series(),
            "grad": _common.norms_of(grads["norm"]),
            "change": _common.change_norms(self.state.model, weights),
            "embed": embed["outputs"],
        }
        del weights, grads, recording
        self.i = self.check_steps
        self.rejected_before = int(self.state.optimizer.total_notfinite)

    def _reference_model(self):
        with torch.device("meta"):
            return T.VICReg(self.tree)

    def _weights(self) -> Dict[str, torch.Tensor]:
        return W.make(self._reference_model(), self.seed, self.device)

    def _fit(self, end: int) -> None:
        self.trainer.limit_train_batches = end
        self.state = self.trainer.fit(self.state, self.i)
        self.i = end

    def warmup(self) -> None:
        k = int(self.traffic["steps_per_dispatch"])
        clamp = self.chunk % k  # the dispatch length the log boundaries clamp to
        end = 2 * self.chunk
        self.i = end - clamp - 1
        self._fit(end)  # an eager step, then a graph of ``clamp`` steps

    def run_for(self, seconds: float, on_unit=None):
        start = _common.aligned(self.i, self.chunk)
        self.state, steps = _common.fit_for(self.trainer, self.state, start, seconds, on_unit, self.batch)
        self.i = start + steps
        return [{"attempted": steps, "steps": steps, "voices": steps * self.batch}]

    def failed(self) -> int:
        return int(self.state.optimizer.total_notfinite) - self.rejected_before

    def render_launches(self, records):
        """(kernel, batch) of each render launch the recorded steps made."""
        return [("render_fwd", self.batch)] * sum(r["steps"] for r in records)

    def model_flops(self, records) -> float:
        from portbench.counts import model_flops

        return model_flops.pretrain_step(self.tree) * sum(r["steps"] for r in records)

    def free(self) -> None:
        del self.trainer, self.task, self.state

    # -- correctness ---------------------------------------------------------------
    def reference(self, precision: str = "fp32") -> Dict:
        strict()
        T.set_precision(precision)
        try:
            weights = self._weights()
            batch_nums = [self.start + j for j in range(self.check_steps)]
            ref = RT.pretrain(_common.reference_tree(self.tree, self.traffic, self.seed), weights,
                              batch_nums, self.device)
            return {**{k: ref[k] for k in ("loss", "embed") + COMPONENTS}, "grad": C.norms(ref["grad"]),
                    "change": C.norms({n: ref["params"][n] - weights[n] for n in weights})}
        finally:
            T.set_precision("fp32")

    def compare(self, outputs: Dict, reference: Dict, limits) -> C.Checks:
        """The training numbers, and the first step's embeddings of both towers
        through the projector (x from the audio, y from the parameters)."""
        checks = C.training(C.Checks(limits), outputs, reference)
        gap = max(C.vector_gap(p, r) for p, r in zip(outputs["embed"], reference["embed"]))
        checks.add("embed_gap_first", gap, "the first step's projector outputs, the larger of x and y")
        return checks
