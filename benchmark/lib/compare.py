"""How ``correct`` is decided for a training cell: the program's first
steps against the reference's, each number that the cell's limits file
names under its limit.

* ``loss_gap``: the largest relative gap of a checked step's loss;
  ``loss1_gap``: the first step's alone;
* ``grad_gap``: over the parameters, the largest gap between the
  program's norm of the first gradient (Adam's first moment after one
  update, over 1 − β1) and the reference's, against the reference's norm of
  that parameter or of the median parameter, whichever is larger;
* ``change_gap``: the largest such gap of the norm of each parameter's
  change over the checked steps, leaving out the parameters whose
  reference gradient is under a thousandth of the median's (moved by
  round-off alone under Adam); ``change1_gap``: the same after the first
  step, whose Adam update is lr·sign(gradient) entry by entry, so that its
  norm counts the entries the step reached;
* ``cot_gap`` (editing): the norm of the difference of the first step's
  SDS cotangents (dL/dlatents, the UNet's CFG noise residual) over the
  reference's norm: its size and its direction;
* ``sds_gain`` (editing, where the first step takes LGIE's local branch):
  how much of the reference's SDS gradient (its backward of the
  *program's* first cotangent through the VAE, the resize and the render
  into every parameter) the program's first gradient carries, once the
  reference's keep_bg gradient is taken out: the least-squares coefficient
  <g − g_bg, g_sds> / <g_sds, g_sds> over all parameters together, 1 where
  the program's backward is the reference's; ``sds_gain_gap`` is
  |sds_gain − 1|.  On the global branch (``--detach_bg``) the SDS gradient
  reaches the field only through the samples whose mask reads 0.5 or more,
  which at the initial field's masks of about 0.5 rounding decides, and the
  keep_bg term (an L1 of two renders of one field, whose sign rounding
  decides where they nearly agree) leads: neither side's first gradient is
  then steady, so the number is read on local first steps alone, and of
  those where the reference's SDS part leads its keep_bg part
  (Σ‖g_sds‖² ≥ Σ‖g_bg‖²); elsewhere the keep_bg term's rounding projects on
  the SDS part by up to a fifth.
"""

from __future__ import annotations

import statistics

MOVING = 1e-3


def _worst(prog: dict, ref: dict, names) -> float:
    """The largest gap of two readings by parameter, each against the
    larger of the reference's reading and the median of them."""
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def gaps(prog: dict, ref: dict) -> dict:
    rel = [abs(a - b) / max(abs(b), 1e-30)
           for a, b in zip(prog["losses"], ref["losses"], strict=True)]
    names = sorted(ref["grads"])
    g_med = statistics.median(ref["grads"][n] for n in names)
    moving = [n for n in names if ref["grads"][n] >= MOVING * g_med]
    out = {"loss_gap": max(rel), "loss1_gap": rel[0],
           "grad_gap": _worst(prog["grads"], ref["grads"], names),
           "change_gap": _worst(prog["change"], ref["change"], moving),
           "change1_gap": _worst(prog["change1"], ref["change1"], moving)}
    if "cot" in prog and "cot" in ref:
        out["cot_gap"] = float((prog["cot"] - ref["cot"]).norm() / ref["cot"].norm())
    if "sds_vecs" in ref and ref["branches"][0]:
        g, sds, bg = prog["grad_vecs"], ref["sds_vecs"], ref["bg_vecs"]
        num = sum(float(((g[n] - bg[n]) * sds[n]).sum()) for n in sds)
        den = sum(float((sds[n] * sds[n]).sum()) for n in sds)
        if den > 0 and den >= sum(float((bg[n] * bg[n]).sum()) for n in bg):
            out["sds_gain"] = num / den
            out["sds_gain_gap"] = abs(out["sds_gain"] - 1.0)
    return out


OPTIONAL = ("sds_gain_gap",)


def judge(numbers: dict, limits: dict) -> bool:
    """Every number the limits name finite and at most its limit; each of
    them there, but for those read only on some steps (``OPTIONAL``)."""
    return all(numbers[n] == numbers[n] and numbers[n] <= limit if n in numbers
               else n in OPTIONAL for n, limit in limits.items())


def compared(numbers: dict, limits: dict) -> dict:
    """Each number the limits name with its limit, for the result line; a
    number that this run does not read (``OPTIONAL``) has the value None."""
    return {n: {"value": numbers.get(n), "limit": limit} for n, limit in limits.items()}


def lines(numbers: dict, limits: dict) -> list:
    return [f"{n} {numbers[n]!r} limit {limit!r}" if n in numbers
            else f"{n} not read limit {limit!r}" for n, limit in limits.items()]
