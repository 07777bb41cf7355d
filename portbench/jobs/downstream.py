"""Downstream inverse synthesis: ``Trainer.fit`` drives ``AudioToParamsTask`` (a
head trained on frozen VICReg towers) on consecutive batch numbers.

Traffic parameters: ``overrides`` (the objective, ``audio_to_params.loss``),
``log_every`` (the loop's log cadence, where the host reads the metrics),
``check_steps`` (the first steps, taken in set-up through the same loop, that
the reference follows), ``profile_seconds``. The window is one
``Trainer.fit`` on the same task and state (``_common.fit_for``).

Set-up builds the pretraining task and state with the benchmark's tower
weights, the downstream task on them (its frozen copy of the towers and, for
the embedding objective, its collapse probe), and the head with the
benchmark's head weights; takes the check steps through ``Trainer.fit``
(recording each step's loss and components, the first gradient the optimizer
receives and the head's change); and warms up one more step.
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

LOSS = "audio_to_params/train/loss"
COMPONENTS = ("param_mse", "mel_l1", "embedding")  # recorded where the objective sums them
HEAD_SEED = 3  # the head's weights come from the run's seed + 3


class Job:
    def __init__(self, tree, traffic, seed: int, device):
        from inverse_audio_synthesis_tpu_torch.train.downstream import AudioToParamsTask
        from inverse_audio_synthesis_tpu_torch.train.loop import Trainer
        from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask

        self.tree, self.traffic, self.seed, self.device = tree, traffic, int(seed), torch.device(device)
        self.cfg = _common.program_config(tree, traffic, seed, device)
        self.ref_tree = _common.reference_tree(tree, traffic, seed)
        self.loss = self.cfg.audio_to_params.loss
        self.batch = int(self.cfg.audio_to_params.batch_size)
        self.chunk = int(traffic["log_every"])
        self.check_steps = int(traffic["check_steps"])
        self.start = _common.first_batch_number(seed)
        pretrain = VicregPretrainTask(self.cfg)
        towers = pretrain.init_state()
        W.load_into(towers.model, self._tower_weights())
        self.task = AudioToParamsTask(self.cfg, pretrain, towers)
        del pretrain, towers
        self.state = self.task.init_state()
        head = self._head_weights()
        W.load_into(self.state.model, head)
        split = _common.ConsecutiveSplit(self.start)

        def trainer(task):
            return Trainer(task, split, log_every=self.chunk, detect_anomaly=False)

        self.trainer = trainer(self.task)
        names = [n for n, _ in self.state.model.named_parameters()]
        recording = _common.RecordingTask(
            self.task, {"loss": LOSS, "frozen": "audio_to_params/train/frozen_vicreg_loss",
                        **{c: f"audio_to_params/train/{c}" for c in COMPONENTS}})
        grads = _common.record_first_gradient(self.state.optimizer, names, full=True)
        pred = _common.record_first_output(self.state.model)
        first = trainer(recording)
        first.limit_train_batches = self.check_steps
        self.state = first.fit(self.state, 0)
        series = recording.series()
        self.program = {
            **series,
            "grad": _common.norms_of(grads["norm"]),
            "change": _common.change_norms(self.state.model, head),
            # the first step's stages, judged from the program's own state
            "objective_at_pred": series["loss"][0],
            "pred": pred["outputs"][0], "pred_grad": pred["grad"],
            "grads": grads["grad"], "head_grads": grads["grad"], "before": grads["before"],
            "update": {n: grads["after"][n] - grads["before"][n] for n in names},
        }
        del head, grads, recording
        self.i = self.check_steps
        self.rejected_before = int(self.state.optimizer.total_notfinite)

    def _tower_weights(self) -> Dict[str, torch.Tensor]:
        with torch.device("meta"):
            model = T.VICReg(self.tree)
        return W.make(model, self.seed, self.device)

    def _head_weights(self) -> Dict[str, torch.Tensor]:
        a = self.tree["audio_to_params"]
        with torch.device("meta"):
            head = T.Head(self.tree["nparams"], self.tree["dim"], a["dropout"])
        return W.make(head, self.seed + HEAD_SEED, self.device)

    def _fit(self, end: int) -> None:
        self.trainer.limit_train_batches = end
        self.state = self.trainer.fit(self.state, self.i)
        self.i = end

    def warmup(self) -> None:
        self._fit(self.i + 1)

    def run_for(self, seconds: float, on_unit=None):
        self.state, steps = _common.fit_for(self.trainer, self.state, self.i, seconds, on_unit, self.batch)
        self.i += steps
        return [{"attempted": steps, "steps": steps, "voices": steps * self.batch}]

    def failed(self) -> int:
        return int(self.state.optimizer.total_notfinite) - self.rejected_before

    def render_launches(self, records):
        """Per step: K1 on the true parameters; for the grad-through-synth
        objectives K1 on the predicted ones and K2 in the backward."""
        weights = self.cfg.audio_to_params.get("loss_weights") or {}
        synth_loss = self.loss == "mel_l1" or (self.loss == "combined" and bool(weights.get("mel_l1")))
        per_step = [("render_fwd", self.batch)] * (2 if synth_loss else 1)
        per_step += [("render_bwd", self.batch)] if synth_loss else []
        return per_step * sum(r["steps"] for r in records)

    def model_flops(self, records) -> float:
        from portbench.counts import model_flops

        return model_flops.downstream_step(self.ref_tree, self.loss) * sum(r["steps"] for r in records)

    def free(self) -> None:
        del self.trainer, self.task, self.state

    # -- correctness ---------------------------------------------------------------
    def reference(self, precision: str = "fp32") -> Dict:
        """The reference's steps from the same weights and batches; and the first
        step's stages from the program's own predictions and gradient (each
        float32 stage in bfloat16 for the control)."""
        strict()
        T.set_precision(precision)
        low = precision != "fp32"
        try:
            head = self._head_weights()
            towers = self._tower_weights()
            batch_nums = [self.start + j for j in range(self.check_steps)]
            ref = RT.downstream(self.ref_tree, towers, head, batch_nums, self.device)
            out = {k: ref[k] for k in ("loss", "pred") + COMPONENTS if k in ref}
            out.update(grad=C.norms(ref["grad"]), change=C.norms({n: ref["params"][n] - head[n] for n in head}))
            stage = RT.downstream_first_step(self.ref_tree, towers, batch_nums[0], self.program["pred"],
                                             self.device, low=low, head_weights=head,
                                             pred_grad=self.program["pred_grad"])
            a = self.ref_tree["audio_to_params"]
            lr = RT.learning_rate(a["optim"], a.get("scheduler"), a["batch_size"], 0)
            update = RT.lars_update(self.program["before"], self.program["grads"], lr,
                                    float(a["optim"]["args"].get("weight_decay", 0.0)), low=low)
            out.update(frozen=[stage["frozen"]], objective_at_pred=stage["objective"],
                       pred_grad=stage["pred_grad"], head_grads=stage["head_grads"], update=update)
            return out
        finally:
            T.set_precision("fp32")

    def compare(self, outputs: Dict, reference: Dict, limits) -> C.Checks:
        """The training numbers, and the first step's stages: the head's
        predictions; the frozen towers' loss of the true pair; the objective and
        its gradient with respect to the predictions, at the program's
        predictions; the head's backward, from the program's gradient at its
        predictions to each parameter's gradient; the LARS update from the
        program's gradient."""
        checks = C.training(C.Checks(limits), outputs, reference)
        r = reference["pred"]
        checks.add("pred_gap_first", C.vector_gap(outputs["pred"], r, r - r.mean(0)),
                   "the head's first predictions, over their spread")
        checks.add("frozen_loss_gap_first", C.loss_gaps(outputs["frozen"][:1], reference["frozen"])[0],
                   "the frozen towers on the first batch")
        checks.add("objective_gap_at_pred", C.loss_gaps([outputs["objective_at_pred"]],
                                                        [reference["objective_at_pred"]])[0],
                   "the first step's objective at the program's predictions")
        checks.add("pred_grad_gap", C.vector_gap(outputs["pred_grad"], reference["pred_grad"]),
                   "the objective's gradient at the program's predictions")
        ref_grads = reference["head_grads"]
        matrices = [n for n, g in ref_grads.items() if g.dim() >= 2]
        dev = ref_grads[matrices[0]].device
        program = torch.cat([outputs["head_grads"][n].reshape(-1).to(dev) for n in matrices])
        checks.add("head_grad_gap", C.vector_gap(program, torch.cat([ref_grads[n].reshape(-1) for n in matrices])),
                   f"the head's backward from the program's gradient at its predictions: its {len(matrices)} "
                   "weight matrices' gradients as one vector")
        ref_norms = C.norms(reference["update"])
        gap_norms = C.norms({n: outputs["update"][n] - reference["update"][n] for n in reference["update"]})
        gap, at = C.worst_leaf_gap({n: ref_norms[n] + gap_norms[n] for n in ref_norms}, ref_norms)
        checks.add("update_gap", gap, f"the first update from the program's gradient, worst leaf {at}")
        return checks
