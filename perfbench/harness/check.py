"""The comparison that decides ``correct``: what the program's warm
rounds produced against the reference's run of the same rounds.

Numbers compared, each against its limit in the workload file: the
allocation's, then each task's own, named ``<number>.<arch>`` (a routed
model's readings swing with routing decisions that flip at near-ties,
a dense model's do not, so each task has limits of its own):
- ``alloc_diff``: clients whose task differs, over the rounds (exact).
- ``loss_gap``: the widest relative gap of the task's reported loss.
- ``grad_gap`` (tau = 1 tasks): the first gradient as AdamW got it, by the
  worst leaf: |norm(program) - norm(reference)| over the larger of the
  reference's norm of that leaf and of the task's median leaf.
- ``change_gap``: the task's change over the rounds, by the worst leaf,
  measured as ``grad_gap``; leaves whose first gradient in the reference
  is under a thousandth of the median leaf's are left out (they move by
  round-off and weight decay alone).
- ``probe_gap``: the widest gap by which the logit of the token the
  program's probe puts first lies below the reference's best.
"""

from __future__ import annotations

import math
import statistics

import torch

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "probe_gap")     # each task's
QUIET = 1e-3      # a leaf's reference gradient under this share of the median is left out


def as_program(ref: dict, tasks: list) -> dict:
    """The reference's readings in the form the program's are read: the
    probe's first tokens, and a first gradient for tau = 1 tasks only."""
    return {"alloc": ref["alloc"], "loss": ref["loss"],
            "probe": [[logits.argmax(-1).tolist() for logits in row] for row in ref["probe"]],
            "first_grad": [g if t["tau"] <= 1 else None
                           for g, t in zip(ref["first_grad"], tasks)],
            "change": ref["change"]}


def _leaf_gap(got: dict, want: dict, keep=None) -> float:
    if got is None or want is None or got.keys() != want.keys():
        return math.inf
    paths = [p for p in want if keep is None or keep(p)]
    if not paths:
        return 0.0
    med = statistics.median(want[p] for p in paths)
    return max(abs(got[p] - want[p]) / max(want[p], med) if want[p] or med else 0.0
               for p in paths)


def names(tasks: list) -> list:
    """The numbers compared in a cell of ``tasks``, in order."""
    return ["alloc_diff"] + [f"{k}.{t['arch']}" for t in tasks for k in NUMBERS
                             if k != "grad_gap" or t["tau"] <= 1]


def compare(prog: dict, ref: dict, tasks: list) -> dict:
    """``names(tasks)`` -> the number read."""
    out = {}
    pa, ra = prog["alloc"], ref["alloc"]
    out["alloc_diff"] = (sum(a != b for x, y in zip(pa, ra) for a, b in zip(x, y))
                         + sum(len(x) for x in pa[len(ra):]) + sum(len(y) for y in ra[len(pa):]))
    for s, t in enumerate(tasks):
        arch = t["arch"]
        gaps = [0.0]
        for x, y in zip(prog["loss"], ref["loss"]):
            a, b = x[s], y[s]
            if (a is None) != (b is None):
                gaps.append(math.inf)
            elif a is not None:
                gaps.append(abs(a - b) / abs(b) if math.isfinite(a) else math.inf)
        out[f"loss_gap.{arch}"] = max(gaps)
        if t["tau"] <= 1:
            out[f"grad_gap.{arch}"] = _leaf_gap(prog["first_grad"][s], ref["first_grad"][s])
        g = ref["first_grad"][s] or {}
        med = statistics.median(g.values()) if g else 0.0
        out[f"change_gap.{arch}"] = _leaf_gap(
            prog["change"][s], ref["change"][s],
            keep=lambda p, g=g, med=med: g.get(p, 0.0) >= QUIET * med)
        probe = [0.0]
        for x, y in zip(prog["probe"], ref["probe"]):
            picks, logits = x[s], y[s]
            if picks is None:
                probe.append(math.inf)
                continue
            logits = logits.to(torch.float64)
            got = logits.gather(-1, torch.tensor(picks, device=logits.device)[:, None])[:, 0]
            probe.append(float((logits.max(-1).values - got).max()))
        out[f"probe_gap.{arch}"] = max(probe)
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number within its limit (a NaN fails)."""
    return all(numbers[k] <= limits[k] for k in numbers)
