"""The numbers that decide ``correct``, from a step's readings.

A side's readings (the program's, or the reference's) over the compared
steps are {'losses': [...], 'first_grads': {key: norm}, 'replay_grads':
{key: norm}, 'changes': {name: norm}}: each loss in step order; the norm
of each leaf's first gradient as its Adam took it (weight decay added;
the program's worked out from its Adam state after that step, exp_avg /
(1 - b1)); the norm of each leaf's gradient in the job's replayed steps
(``Job.replay_steps``, steps that run as a replay of the captured graph:
the program's from its Adam state across the step, (exp_avg - b1 *
exp_avg before) / (1 - b1), keyed by the step's index); and the norm of
each parameter's change over the compared steps. Six numbers, each the
worst over its kind but one:

- ``loss_gap``: |program - reference| / |reference| over the losses of
  the first ``first`` of them: each optimizer path's first step, which the
  program runs eagerly before it captures its graph;
- ``replay_loss_gap``: the same over the later losses, which the
  program's graph replays produce;
- ``grad_gap``: |program norm - reference norm| over the first gradients'
  leaves, each divided by the larger of the reference's norm of that leaf
  and of the median leaf (some gradients are all but zero);
- ``replay_grad_gap``: the same over the replayed steps' gradients;
- ``replay_grad_median_gap``: the median leaf's gap in each replayed step,
  the worst over those steps: a steadier number, for a cell whose later
  steps move a few leaves far apart by the rounding of the steps before
  (a fault of one replayed step moves most of its leaves);
- ``change_gap``: the same over the parameters' changes, leaving out a
  parameter whose reference first gradient is under a thousandth of the
  median leaf's in every optimizer that steps it (Adam moves such a leaf
  by round-off alone).

A leaf that one side has and the other lacks counts as a norm of 0 on the
side that lacks it, so a leaf left unmoved, or moved that should not be,
reads 1 or more.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

NUMBERS = ("loss_gap", "replay_loss_gap", "grad_gap", "replay_grad_gap",
           "replay_grad_median_gap", "change_gap")
NEGLIGIBLE = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keys) -> Dict[str, float]:
    """{leaf: |program norm - reference norm|} over the larger of the
    leaf's and the median leaf's reference norm."""
    keys = list(keys)
    if not keys:
        return {}
    median = statistics.median(ref.get(k, 0.0) for k in keys)
    gaps = {}
    for k in keys:
        r, p = ref.get(k, 0.0), prog.get(k, 0.0)
        floor = max(r, median)
        gap = abs(p - r) / floor if floor > 0 else (0.0 if p == 0 else math.inf)
        gaps[k] = gap if math.isfinite(p) else math.inf
    return gaps


def _worst_norm_gap(prog: Dict[str, float], ref: Dict[str, float],
                    keys) -> float:
    return max(leaf_gaps(prog, ref, keys).values(), default=0.0)


def _loss_gap(prog, ref) -> float:
    worst = 0.0
    for p, r in zip(prog, ref):
        gap = abs(p - r) / abs(r) if r else abs(p)
        worst = max(worst, gap if math.isfinite(p) else math.inf)
    return worst


def numbers(prog: dict, ref: dict, first: int) -> Dict[str, float]:
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the two sides ran different numbers of losses")
    loss_gap = _loss_gap(prog["losses"][:first], ref["losses"][:first])
    replay_loss_gap = _loss_gap(prog["losses"][first:], ref["losses"][first:])
    grads = ref["first_grads"]
    grad_gap = _worst_norm_gap(prog["first_grads"], grads,
                               set(grads) | set(prog["first_grads"]))
    replay = ref["replay_grads"]
    gaps = leaf_gaps(prog["replay_grads"], replay,
                     set(replay) | set(prog["replay_grads"]))
    replay_grad_gap = max(gaps.values(), default=0.0)
    by_step: Dict[str, list] = {}
    for key, gap in gaps.items():
        by_step.setdefault(key.split(":", 1)[0], []).append(gap)
    replay_grad_median_gap = max((statistics.median(g)
                                  for g in by_step.values()), default=0.0)
    g_median = statistics.median(grads.values()) if grads else 0.0
    best: Dict[str, float] = {}
    for key, norm in grads.items():
        name = key.split(":", 1)[1]
        best[name] = max(best.get(name, 0.0), norm)
    moved = {n for n, g in best.items() if g >= NEGLIGIBLE * g_median}
    changes = set(ref["changes"]) | set(prog["changes"])
    change_gap = _worst_norm_gap(prog["changes"], ref["changes"],
                                 {n for n in changes if n in moved
                                  or ref["changes"].get(n, 0.0) == 0.0})
    return {"loss_gap": loss_gap, "replay_loss_gap": replay_loss_gap,
            "grad_gap": grad_gap, "replay_grad_gap": replay_grad_gap,
            "replay_grad_median_gap": replay_grad_median_gap,
            "change_gap": change_gap}


def verdict(values: Dict[str, float], limits: Dict[str, float],
            not_compared=()) -> dict:
    """{number: {'value', 'limit'}} of every number but those
    ``not_compared`` names, and whether each is within its limit (a
    missing limit fails)."""
    checks = {k: {"value": values[k], "limit": limits.get(k)}
              for k in NUMBERS if k not in not_compared}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return {"checks": checks, "correct": ok}
