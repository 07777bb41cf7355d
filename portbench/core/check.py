"""The numbers that decide ``correct``, each beside its limit.

Training cells compare the program's first steps with the reference's: each
step's loss; the norm of every parameter's first gradient, as the optimizer
received it; and the norm of every parameter's change after the followed
steps. A norm is compared by the worst leaf: |program - reference| over the
larger of the reference's norm of that leaf and the median leaf's, or by the
median leaf's gap where the worst leaf's is round-off (see PERF.md). Leaves
whose reference gradient is below a thousandth of the median leaf's are left
out of both (their gradients and moves are round-off: a bias before a
BatchNorm).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

import torch


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    values = torch.stack([torch.linalg.vector_norm(tensors[n].float()) for n in names]).tolist()
    return dict(zip(names, values))


def worst_leaf_gap(program: Dict[str, float], reference: Dict[str, float],
                   leaves: Optional[List[str]] = None) -> Tuple[float, str]:
    """(largest gap, the leaf it is at)."""
    leaves = list(reference) if leaves is None else leaves
    median = statistics.median(reference[n] for n in leaves)
    worst, at = 0.0, ""
    for n in leaves:
        gap = abs(program[n] - reference[n]) / max(reference[n], median, 1e-30)
        if not math.isfinite(gap):
            return math.inf, n
        if gap > worst:
            worst, at = gap, n
    return worst, at


def vector_gap(program: torch.Tensor, reference: torch.Tensor, scale: Optional[torch.Tensor] = None) -> float:
    """||program - reference|| / ||scale|| (scale: the reference), inf where the
    shapes differ or the values are not finite."""
    if program is None or tuple(program.shape) != tuple(reference.shape):
        return math.inf
    gap = float(torch.linalg.vector_norm(program.float() - reference.float())
                / torch.linalg.vector_norm((reference if scale is None else scale).float()))
    return gap if math.isfinite(gap) else math.inf


def moving_leaves(reference_grad: Dict[str, float]) -> List[str]:
    median = statistics.median(reference_grad.values())
    return [n for n, v in reference_grad.items() if v >= 1e-3 * median]


def loss_gaps(program: List[float], reference: List[float]) -> List[float]:
    """|program - reference| / |reference| at each step."""
    if len(program) != len(reference):
        return [math.inf]
    gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program, reference)]
    return [g if math.isfinite(g) else math.inf for g in gaps]


def training(checks: "Checks", outputs: Dict, reference: Dict) -> "Checks":
    """A training cell's numbers: each step's loss (the largest gap, and the
    first step's; for a summed objective each component's at the first step),
    the first gradient's norms and the change's norms, each by the worst leaf
    and by the median leaf."""
    gaps = loss_gaps(outputs["loss"], reference["loss"])
    checks.add("loss_gap", max(gaps), f"{len(gaps)} steps")
    checks.add("loss_gap_first", gaps[0], "the first step")
    for part in ("param_mse", "mel_l1", "embedding", "repr_loss", "std_loss", "cov_loss"):  # summed terms
        if part in reference and part in outputs:
            first = loss_gaps(outputs.get(part, [])[:1], reference[part][:1])[0]
            checks.add(f"{part}_gap_first", first, f"the first step's {part} term")
    moving = moving_leaves(reference["grad"])
    gap, at = worst_leaf_gap(outputs["grad"], reference["grad"], moving)
    checks.add("grad_norm_gap", gap, f"worst leaf {at}")
    checks.add("grad_norm_gap_median", median_leaf_gap(outputs["grad"], reference["grad"], moving), "median leaf")
    gap, at = worst_leaf_gap(outputs["change"], reference["change"], moving)
    checks.add("change_norm_gap", gap, f"worst leaf {at}, {len(moving)} of {len(reference['grad'])} leaves")
    checks.add("change_norm_gap_median", median_leaf_gap(outputs["change"], reference["change"], moving),
               "median leaf")
    return checks


def median_leaf_gap(program: Dict[str, float], reference: Dict[str, float],
                    leaves: Optional[List[str]] = None) -> float:
    """The median over leaves of the same per-leaf gap as ``worst_leaf_gap``."""
    leaves = list(reference) if leaves is None else leaves
    median = statistics.median(reference[n] for n in leaves)
    gaps = [abs(program[n] - reference[n]) / max(reference[n], median, 1e-30) for n in leaves]
    return statistics.median(g if math.isfinite(g) else math.inf for g in gaps)


class Checks:
    """Named numbers with their limits; ``correct`` when every one is finite and
    at or under its limit. A job computes every number it can; those the cell's
    file gives no limit are not compared (``limits=None``: all, with no limit,
    for reading them)."""

    def __init__(self, limits: Optional[Dict[str, float]]):
        self.limits = limits
        self.rows: List[Tuple[str, float, float]] = []
        self.notes: Dict[str, str] = {}

    def add(self, name: str, value: float, note: str = "") -> None:
        if self.limits is not None and name not in self.limits:
            return
        limit = math.inf if self.limits is None else float(self.limits[name])
        self.rows.append((name, float(value), limit))
        if note:
            self.notes[name] = note

    @property
    def correct(self) -> bool:
        """Every number finite and within its limit, and every limit's number there."""
        named = {n for n, _, _ in self.rows}
        complete = self.limits is None or set(self.limits) <= named
        return bool(self.rows) and complete and all(math.isfinite(v) and v <= lim for _, v, lim in self.rows)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {n: {"value": v, "limit": lim} for n, v, lim in self.rows}

    def lines(self) -> List[str]:
        return [f"check {n}: {v!r} limit {lim!r}" + (f" ({self.notes[n]})" if n in self.notes else "")
                for n, v, lim in self.rows]
