"""The numbers that decide ``correct``, each against its limit (the limits
are data: ``portbench/workloads/<cell>.json``, with the readings they were
set from in PERF.md).

Training: the norm of step 1's clipped gradient, leaf by leaf, and the
norm of each leaf's change over the check steps: the gap between the
program's norm and the reference's, over the reference's norm of that
leaf or of the median leaf, whichever is larger; the worst leaf is the
reading. Leaves whose gradient in the reference is under a thousandth of
the median leaf's (a key bias under the softmax) move by round-off alone
and are left out of the change. Norms of whole leaves average rounding
away, so no precision one step down (the fp8 control) moves them three
times as far as bf16 does; the step-1 gradient itself does: ``grad_diff``
is the norm of the program's step-1 gradient minus the reference's, leaf by
leaf, over the same denominator. The losses are read and not compared
(PERF.md: the first step's is under 2e-4 on every seed and neither the
control nor a fault moves it ten times as far).

Answers: the widest gap by which the reference's logit of the answer given
lies below the reference's best; for served answers also the widest
relative gap of the confidence given to the reference's probability of
that answer."""
from __future__ import annotations

import statistics

import torch

TINY_GRAD = 1e-3


def _rel(a: float, b: float, floor: float) -> float:
    return abs(a - b) / max(abs(b), floor)


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in ref)
    return max(_rel(prog[k], ref[k], med) for k in names)


def train_readings(prog: dict, ref: dict) -> dict:
    """prog and ref: {"loss": [...], "grad": {leaf: norm}, "change": {leaf:
    norm}, "g1": {leaf: step 1's gradient}}; ref also "grad_raw"."""
    med = statistics.median(ref["grad_raw"].values())
    moved = {k for k, g in ref["grad_raw"].items() if g >= TINY_GRAD * med}
    out = {"loss": _rel(prog["loss"][0], ref["loss"][0], 0.0),
           "loss_later_steps": max(_rel(a, b, 0.0) for a, b in
                                   zip(prog["loss"][1:], ref["loss"][1:])),
           "grad_norm": leaf_gap(prog["grad"], ref["grad"]),
           "param_change": leaf_gap(prog["change"], ref["change"], moved)}
    if "g1" in prog and "g1" in ref:
        med = statistics.median(ref["grad"].values())
        out["grad_diff"] = max(
            (prog["g1"][k].to(g.device) - g).norm().item() / max(ref["grad"][k], med)
            for k, g in ref["g1"].items())
    return out


def answer_readings(ref_logits: torch.Tensor, answer: torch.Tensor,
                    confidence: torch.Tensor | None = None) -> dict:
    """ref_logits [N, labels] float32; answer [N] label indices; confidence
    [N] (served answers)."""
    best = ref_logits.max(-1).values
    given = ref_logits.gather(-1, answer[:, None].long())[:, 0]
    out = {"answer_gap": (best - given).max().item()}
    if confidence is not None:
        p = torch.softmax(ref_logits, -1).gather(-1, answer[:, None].long())[:, 0]
        out["confidence_gap"] = ((confidence - p).abs() / p).max().item()
    return out


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every reading within its limit, {name: {"value", "limit"}})."""
    checks = {k: {"value": readings.get(k), "limit": limits[k]} for k in limits}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
