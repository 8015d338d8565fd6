"""The numbers that decide ``correct``: the program's first training steps
against the plain reference's, from the same inputs, weights and draws.

* ``logits``: step 1's logits, the widest gap over every node and class,
  against the reference's largest |logit|;
* ``loss``: each of the steps' losses, the widest relative gap;
* ``grad``: step 1's gradient as the optimizer got it, by the worst
  leaf: the gap between the program's norm and the reference's, against
  the reference's norm of that leaf or of the median leaf, whichever is
  larger;
* ``change``: the parameters' change over the steps, measured the same
  way, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's (a smaller one moves under Adam by round-off).

A number passes where it is at most its limit (``limits/<cell>.json``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

NUMBERS = ("logits", "loss", "grad", "change")
# a leaf whose reference gradient norm is under this share of the median
# leaf's is left out of ``change``
MOVED_SHARE = 1e-3


def _median(values):
    v = sorted(values)
    n = len(v)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def _gaps(prog: Dict[str, float], ref: Dict[str, float],
          keys) -> Dict[str, float]:
    med = _median([ref[k] for k in keys])
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keys}


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(prog, ref, params0) -> Dict[str, Dict[str, float]]:
    """Each leaf's gap of ``grad`` and of ``change`` (``change`` over the
    leaves that count), as the worst-leaf numbers take them."""
    keys = sorted(ref.grads1)
    g_prog = {k: _norm(prog.grads1[k]) for k in keys}
    g_ref = {k: _norm(ref.grads1[k]) for k in keys}
    d_prog = {k: _norm(prog.params[k] - params0[k]) for k in keys}
    d_ref = {k: _norm(ref.params[k] - params0[k]) for k in keys}
    med_g = _median(g_ref.values())
    moved = [k for k in keys if g_ref[k] >= MOVED_SHARE * med_g]
    return {"grad": _gaps(g_prog, g_ref, keys),
            "change": _gaps(d_prog, d_ref, moved)}


def readings(prog, ref, params0) -> Dict[str, float]:
    """The four numbers of ``prog`` against ``ref`` (``reference.Run``
    each), ``params0`` the weights both started from."""
    keys = sorted(ref.grads1)
    missing = set(keys) ^ set(prog.grads1)
    if missing:
        raise ValueError(f"parameters differ from the reference's: "
                         f"{sorted(missing)}")
    gap = (prog.logits1.double() - ref.logits1.double()).abs().max()
    logits = float(gap) / max(float(ref.logits1.abs().max()), 1e-30)
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(prog.losses, ref.losses))
    if len(prog.losses) != len(ref.losses) or not all(
            math.isfinite(v) for v in prog.losses):
        loss = math.inf
    leaves = leaf_gaps(prog, ref, params0)
    return {"logits": logits, "loss": loss,
            "grad": max(leaves["grad"].values()),
            "change": max(leaves["change"].values())}


def judge(numbers: Dict[str, float],
          limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, each number beside its limit).  A number that is not
    finite, or has no limit, fails."""
    checks, ok = {}, True
    for name in NUMBERS:
        value, limit = numbers.get(name, math.nan), limits.get(name)
        passed = (limit is not None and math.isfinite(value)
                  and value <= limit)
        ok = ok and passed
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
