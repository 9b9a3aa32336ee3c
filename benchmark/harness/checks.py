"""The numbers that decide ``correct``, each beside its limit, and the
gaps they are made of."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


def all_ok(checks: List[Check]) -> bool:
    return bool(checks) and all(c.ok for c in checks)


def as_json(checks: List[Check]) -> Dict:
    return {c.name: {"value": c.value, "limit": c.limit} for c in checks}


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in leaves.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Optional[set] = None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    pn, rn = leaf_norms(prog), leaf_norms(ref)
    keys = [k for k in rn if keep is None or k in keep]
    median = float(np.median([rn[k] for k in keys]))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], median, 1e-30) for k in keys}


def worst_leaf_gap(prog: Dict[str, torch.Tensor],
                   ref: Dict[str, torch.Tensor],
                   keep: Optional[set] = None):
    """The largest of :func:`leaf_gaps`; returns (gap, leaf)."""
    gaps = leaf_gaps(prog, ref, keep)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def median_leaf_gap(prog: Dict[str, torch.Tensor],
                    ref: Dict[str, torch.Tensor],
                    keep: Optional[set] = None) -> float:
    """The median of :func:`leaf_gaps`: the gap of the median leaf."""
    return float(np.median(list(leaf_gaps(prog, ref, keep).values())))


def moved_leaves(first_grads: Dict[str, torch.Tensor]) -> set:
    """Leaves whose reference gradient is more than a thousandth of the
    median leaf's: the others (a bias under a BatchNorm) are nought to
    rounding and move under Adam by round-off alone."""
    norms = leaf_norms(first_grads)
    median = float(np.median(list(norms.values())))
    return {k for k, v in norms.items() if v > 1e-3 * median}
