"""The numbers that decide ``correct``, each against its limit.

Every number is a gap between what the program produced and what the
plain reference works out from the same inputs; a cell's limits are in its
workload file (``limits``), set from readings of sound runs and of the
control on the card (``PERF.md`` gives the readings). A number is within
its limit when it is at most the limit; a number that could not be read
(NaN) is not.
"""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, List, Optional, Sequence

import torch

# a leaf whose reference gradient is under this share of the median leaf's
# is nought to rounding (a bias that a normalisation or a softmax cancels):
# Adam moves it by round-off alone, so its change is not compared
ROUNDING_LEAF = 1e-3


def leaf_norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keys: Optional[Sequence[str]] = None) -> List[float]:
    """Each leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger (not the norm of their difference). A leaf missing
    from the program reads 1."""
    keys = list(ref) if keys is None else list(keys)
    rn = leaf_norms(ref)
    med = statistics.median(rn.values())
    out = []
    for k in keys:
        if k not in prog:
            out.append(1.0)
            continue
        pn = float(torch.linalg.vector_norm(prog[k].double()))
        out.append(abs(pn - rn[k]) / max(rn[k], med, 1e-30)
                   if math.isfinite(pn) else math.nan)
    return out


def worst(values: Sequence[float]) -> float:
    if not values or any(math.isnan(v) for v in values):
        return math.nan
    return max(values)


def moved_leaves(raw_grad: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding."""
    n = leaf_norms(raw_grad)
    med = statistics.median(n.values())
    return [k for k, v in n.items() if v >= ROUNDING_LEAF * med]


def trajectory(prog: dict, ref: dict) -> Dict[str, float]:
    """A training cell's numbers, program against reference: each step's
    loss (the worst step, and the first step's alone), the first gradient
    and each leaf's change after the last step (the worst leaf of each).
    A cell's ``limits`` name the ones it compares."""
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not losses:
        losses = [math.nan]
    grad = leaf_gaps(prog["grad1"], ref["grad1"])
    change = leaf_gaps(prog["delta"], ref["delta"],
                       moved_leaves(ref["raw1"]))
    return {"loss_gap": worst(losses), "loss_gap_first": losses[0],
            "grad_gap": worst(grad), "change_gap": worst(change)}


def logit_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest gap of a logit, against the largest reference logit of
    that answer."""
    prog, ref = prog.double(), ref.double()
    if prog.shape != ref.shape:
        return math.nan
    scale = max(float(ref.abs().max()), 1e-30)
    gap = float((prog - ref).abs().max())
    return gap / scale if math.isfinite(gap) else math.nan


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> (bool, Dict[str, dict]):
    """``(correct, {name: {"value", "limit"}})`` over every limit; a
    number without a reading counts as NaN, which fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, math.nan)
        v = float(v) if v is not None else math.nan
        within = math.isfinite(v) and v <= float(limit)
        ok = ok and within
        out[name] = {"value": v, "limit": float(limit)}
    return ok, out


def print_lines(checks: Dict[str, dict]) -> None:
    """Each number beside its limit, as the last lines on stderr."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
