"""VICReg pretraining with the AST audio tower (``audio_tower.name: ast``):
the pretraining job (``jobs/pretrain.py``: the same loop, set-up, window and
comparison), with the AST reference model (``reference/ast.py``), LayerNorm
scales of 1 in the weights both sides start from (``core/weights.py`` sets
every 1-D parameter that is not a BatchNorm scale to 0), and model FLOPs
counted at the batch the traffic's ``overrides`` set (``counts/ast_flops.py``).
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.core import check as C
from portbench.core import weights as W
from portbench.jobs import _common
from portbench.jobs import pretrain
from portbench.reference import ast as A
from portbench.reference import strict
from portbench.reference import towers as T


class Job(pretrain.Job):
    def _reference_model(self):
        with torch.device("meta"):
            return A.VICReg(self.tree)

    def _weights(self) -> Dict[str, torch.Tensor]:
        model = self._reference_model()
        weights = W.make(model, self.seed, self.device)
        for name in A.layer_norm_scales(model):
            weights[name].fill_(1.0)
        return weights

    def model_flops(self, records) -> float:
        from portbench.counts import ast_flops

        tree = _common.reference_tree(self.tree, self.traffic, self.seed)
        return ast_flops.pretrain_step(tree) * sum(r["steps"] for r in records)

    def reference(self, precision: str = "fp32") -> Dict:
        strict()
        T.set_precision(precision)
        try:
            weights = self._weights()
            batch_nums = [self.start + j for j in range(self.check_steps)]
            ref = A.pretrain(_common.reference_tree(self.tree, self.traffic, self.seed), weights,
                             batch_nums, self.device)
            return {**{k: ref[k] for k in ("loss", "embed") + pretrain.COMPONENTS}, "grad": C.norms(ref["grad"]),
                    "change": C.norms({n: ref["params"][n] - weights[n] for n in weights})}
        finally:
            T.set_precision("fp32")
