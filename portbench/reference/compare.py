"""The comparison that decides ``correct`` for a training cell.

The program's readings of its first steps are held against the plain
reference's readings of the same steps from the same inputs:

* ``loss.<t>``: the relative gap of step ``t``'s loss;
* ``grad``: the first gradient (as the optimizer received it), the worst
  leaf's gap between the program's norm and the reference's norm;
* ``delta``: each parameter's change over the steps, the same way;
* ``grad_diff``: the first gradient, the worst leaf's norm of the
  difference between the program's and the reference's.  The gap of two
  norms cannot see unbiased rounding, which moves a norm by far less than
  it moves the values; the cells whose control only this number catches
  compare it.

A leaf's gap is measured against the reference's norm of that leaf or of
the median leaf, whichever is larger (some gradients are all but zero).
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both: they move by round-off alone.  A number that
is not finite fails.
"""
from __future__ import annotations

import math
import statistics

import torch

#: A leaf whose reference gradient norm is under this share of the median
#: leaf's moves by round-off alone.
NEGLIGIBLE = 1e-3


def _worst(gaps: list, norms: list, keep: list) -> float:
    """The worst kept leaf's gap over the larger of that leaf's reference
    norm and the median kept leaf's."""
    scale = statistics.median(norms[i] for i in keep)
    rel = [gaps[i] / max(norms[i], scale) for i in keep]
    return max(rel) if all(map(math.isfinite, rel)) else math.inf


def _norm_gaps(prog: list, ref: list) -> list:
    return [abs(p - r) for p, r in zip(prog, ref)]


def readings_gaps(prog: dict, ref: dict) -> dict:
    """Every compared number's value for program readings ``prog``."""
    out = {f"loss.{t}": abs(p - r) / abs(r)
           for t, (p, r) in enumerate(zip(prog["losses"], ref["losses"]))}
    med = statistics.median(ref["grad_norms"])
    keep = [i for i, n in enumerate(ref["grad_norms"])
            if n >= NEGLIGIBLE * med]
    g_ref, d_ref = ref["grad_norms"], ref["delta_norms"]
    out["grad"] = _worst(_norm_gaps(prog["grad_norms"], g_ref), g_ref, keep)
    out["grad_diff"] = _worst(
        [float(torch.linalg.vector_norm(p.double() - r.double()))
         for p, r in zip(prog["grads"], ref["grads"])], g_ref, keep)
    out["delta"] = _worst(_norm_gaps(prog["delta_norms"], d_ref), d_ref,
                          keep)
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def numbers(prog: dict, ref: dict, limits: dict) -> list[dict]:
    """``[{"name", "value", "limit"}]`` for every number ``limits`` names
    (the cell's limits file);
    a number passes when its value is at most its limit."""
    gaps = readings_gaps(prog, ref)
    return [{"name": k, "value": gaps[k], "limit": float(lim)}
            for k, lim in limits["limits"].items()]


def passed(nums: list[dict]) -> bool:
    return all(math.isfinite(n["value"]) and n["value"] <= n["limit"]
               for n in nums)
