"""The comparison that decides ``correct``: the program's first three
training steps against the plain reference's, from the same weights and
inputs.

Three numbers, each held to its own limit (``limits/<cell>.json``):

* ``loss_gap``: the largest of the three steps' |loss - reference| /
  |reference|;
* ``grad_gap``: over the kept parameters ("leaves", below), the median
  of each leaf's gap between the norm of the program's first gradient,
  as its optimizer holds it after one step, and the reference's, over
  the larger of the reference's norm of that leaf and the median kept
  leaf's.
  The median and not the worst leaf: the worst is an attention vector
  (or a small projection) whose gradient is what is left after nearly
  all of its terms cancel, and one edge whose logit lies within
  rounding of leaky_relu's kink takes the other slope there; it reads
  from 1e-10 to 1e-5 from seed to seed, the median leaf within a few
  times its median (PERF.md);
* ``change_gap``: the worst kept leaf's gap of the norm of its change
  over the three steps (the parameters step 4 starts from).

Kept are the leaves whose reference gradient is at least a thousandth of
the median leaf's: a leaf with a gradient nought to rounding moves under
Adam by its round-off's sign alone, and leaves whose gradient is 0 on
both sides (relations whose output reaches no loss) would pull the
median leaf down to a live leaf's low quantile."""

from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
KEEP = 1e-3


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """Each leaf's |program norm - reference norm| over the larger of its
    reference norm and the median leaf's."""
    names = list(names)
    if not names:
        return {}
    med = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in names}


def _worst(gaps: dict):
    if not gaps:
        return 0.0, None
    k = max(gaps, key=lambda q: (not math.isfinite(gaps[q]), gaps[q]))
    return gaps[k], k


def gaps(prog: dict, ref: dict) -> dict:
    """The three numbers (and the worst leaf of each) between two runs'
    ``{"losses", "grad", "change"}``."""
    if set(prog["grad"]) != set(ref["grad"]):
        raise ValueError("the program's parameters are not the reference's")
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("a different number of checked steps")
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"]))
    med = statistics.median(ref["grad"].values())
    kept = [k for k, v in ref["grad"].items() if v >= KEEP * med]
    per_grad = leaf_gaps(prog["grad"], ref["grad"], kept)
    per_change = leaf_gaps(prog["change"], ref["change"], kept)
    grad_worst, grad_leaf = _worst(per_grad)
    change, change_leaf = _worst(per_change)
    return {"loss_gap": loss,
            "grad_gap": statistics.median(per_grad.values()),
            "change_gap": change, "grad_worst": grad_worst,
            "worst": {"grad": grad_leaf, "change": change_leaf},
            "left_out": sorted(set(ref["grad"]) - set(kept)),
            "leaves": {"grad": per_grad, "change": per_change}}


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number at most its
    limit; a NaN passes no limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
