"""VICReg pretraining with the HTS-AT audio tower (``audio_tower.name:
htsat``): the pretraining job (``jobs/pretrain.py``: the same loop, set-up,
window and comparison), with the HTS-AT reference model
(``reference/htsat.py``), LayerNorm scales of 1 in the weights both sides
start from (``core/weights.py`` sets every 1-D parameter that is not a
BatchNorm scale to 0; the reference's LayerNorm is ``reference/ast.py``'s),
model FLOPs counted at the batch the traffic's ``overrides`` set
(``counts/htsat_flops.py``), and one number more in the comparison: the
bias tables' first gradients, each by its own norm (``bias_grad_gap``).
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.core import check as C
from portbench.core import weights as W
from portbench.jobs import _common
from portbench.jobs import pretrain
from portbench.reference import ast as A
from portbench.reference import htsat as H
from portbench.reference import strict
from portbench.reference import towers as T

BIAS_TABLE = "relative_position_bias_table"


class Job(pretrain.Job):
    def _reference_model(self):
        with torch.device("meta"):
            return H.VICReg(self.tree)

    def _weights(self) -> Dict[str, torch.Tensor]:
        model = self._reference_model()
        weights = W.make(model, self.seed, self.device)
        for name in A.layer_norm_scales(model):
            weights[name].fill_(1.0)
        return weights

    def model_flops(self, records) -> float:
        from portbench.counts import htsat_flops

        tree = _common.reference_tree(self.tree, self.traffic, self.seed)
        return htsat_flops.pretrain_step(tree) * sum(r["steps"] for r in records)

    def compare(self, outputs: Dict, reference: Dict, limits) -> C.Checks:
        """The pretraining numbers, and the relative-position bias tables' first
        gradients by the worst table, each table's gap over the larger of its
        own norm and the median table's. The leaf-wise gaps scale a leaf by
        the larger of its norm and the median leaf's, and a table's gradient
        is 0.5-7% of the median leaf's at HTSAT-base: a table given half its
        gradient moves them no more than rounding does (PERF.md)."""
        checks = super().compare(outputs, reference, limits)
        tables = [n for n in reference["grad"] if n.endswith(BIAS_TABLE)]
        gap, at = C.worst_leaf_gap(outputs["grad"], reference["grad"], tables)
        checks.add("bias_grad_gap", gap, f"worst of {len(tables)} tables {at}")
        return checks

    def reference(self, precision: str = "fp32") -> Dict:
        strict()
        T.set_precision(precision)
        try:
            weights = self._weights()
            batch_nums = [self.start + j for j in range(self.check_steps)]
            ref = H.pretrain(_common.reference_tree(self.tree, self.traffic, self.seed), weights,
                             batch_nums, self.device)
            return {**{k: ref[k] for k in ("loss", "embed") + pretrain.COMPONENTS}, "grad": C.norms(ref["grad"]),
                    "change": C.norms({n: ref["params"][n] - weights[n] for n in weights})}
        finally:
            T.set_precision("fp32")
