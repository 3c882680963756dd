"""How ``correct`` is decided: the program's first rounds against the plain
reference's, from the same weights, tokens and probes.

Four numbers, each against a limit of the cell's (``workloads/<cell>.
json``, ``limits``):

* ``loss``: the largest |program − reference| / |reference| of the
  rounds' losses;
* ``mom``, ``dstat``, ``change``: the worst leaf's gap between the
  program's norm and the reference's (``reference/measures.py``), over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger. ``change`` leaves out the leaves whose first gradient (their
  ``mom`` norm) is under a thousandth of the median leaf's in the
  reference: their change is round-off alone (a key bias under softmax).

A number that is not finite, or is above its limit, fails.

The rounds compared are the first ``FIRST_ROUNDS``, the same in every
cell: ``mom`` and ``dstat`` are read after round 0 and ``change`` after
the last of them, so the count is part of what ``correct`` means and no
cell sets its own.
"""
from __future__ import annotations

import math
import statistics

NUMBERS = ("loss", "mom", "dstat", "change")
FIRST_ROUNDS = 3
SMALL_GRAD = 1e-3


def _leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


def gaps(prog: dict, ref: dict) -> dict:
    """Each number's gaps: by round for ``loss``, by leaf for the others."""
    med = statistics.median(ref["mom"].values())
    moving = [k for k, v in ref["mom"].items() if v >= SMALL_GRAD * med]
    return {"loss": {r: abs(p - q) / abs(q) for r, (p, q) in
                     enumerate(zip(prog["losses"], ref["losses"]))},
            "mom": _leaf_gaps(prog["mom"], ref["mom"], ref["mom"]),
            "dstat": _leaf_gaps(prog["dstat"], ref["dstat"], ref["dstat"]),
            "change": _leaf_gaps(prog["change"], ref["change"], moving)}


def _top(d: dict):
    """(the largest gap, where): NaN where any gap is NaN (``max`` would
    pass over it)."""
    bad = [k for k, v in d.items() if math.isnan(v)]
    at = bad[0] if bad else max(d, key=d.get)
    where = "/".join(map(str, at)) if isinstance(at, tuple) else f"round {at}"
    return (math.nan if bad else d[at]), where


def readings(prog: dict, ref: dict) -> dict:
    return {k: _top(d)[0] for k, d in gaps(prog, ref).items()}


def compare(prog: dict, ref: dict, limits: dict):
    """(correct, {number: {"value", "limit"}}, {number: the round or leaf
    that sets it})."""
    top = {k: _top(d) for k, d in gaps(prog, ref).items()}
    ok, checks = judge({k: v for k, (v, _) in top.items()}, limits)
    return ok, checks, {k: w for k, (_, w) in top.items()}


def judge(read: dict, limits: dict):
    """(correct, {number: {"value", "limit"}})."""
    checks = {k: {"value": read[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
