"""The arithmetic of the readers of the program's own spans and marks
(``metrics/fwd_ms.py``, ``bwd_ms.py``, ``adam_ms.py``,
``step_idle_pct.py``).

The program (``avsiam_tpu_torch/utils/profiling.py``) names its host
spans ``avsiam.*``: ``avsiam.step`` is one call of the step. Its graphed steps hold device marks,
which ``phase_ms()`` of the cell's step object (``ctx.job.step_fn``)
returns as {graph: {phase: device ms of the graph's last replay}}: one
graph 'step' for the pretrain step, one a branch for the finetune step.
A program without them (no ``phase_ms``, no ``avsiam.*`` span in the
trace) reads None, and the metric is left out.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

STEP = "avsiam.step"


def phases(ctx) -> Optional[Dict[str, float]]:
    """{phase: device ms} a step: each graph's phases, weighted over the
    graphs by the window's route counts (``ctx.job.branches``) where the
    job routes, else each graph alike. None without marks."""
    read = getattr(getattr(ctx.job, "step_fn", None), "phase_ms", None)
    if read is None:
        return None
    by_graph = {g: p for g, p in read().items() if p}
    counts = Counter(getattr(ctx.job, "branches", None) or ())
    weights = ({g: counts[g] for g in by_graph} if counts
               else dict.fromkeys(by_graph, 1))
    total = sum(weights.values())
    if not by_graph or total <= 0:
        return None
    out: Dict[str, float] = {}
    for g, p in by_graph.items():
        for name, ms in p.items():
            out[name] = out.get(name, 0.0) + ms * weights[g] / total
    return out


def phase_ms(ctx, kind: str) -> Optional[float]:
    """Device ms a step of the phases of ``kind``: 'fwd' (named fwd*),
    'bwd' (bwd*) or 'other' (every other phase: gradient zeroing, means,
    Adam)."""
    p = phases(ctx)
    if p is None:
        return None
    if kind == "other":
        return sum(ms for n, ms in p.items()
                   if not n.startswith(("fwd", "bwd")))
    return sum(ms for n, ms in p.items() if n.startswith(kind))


def _spans(ctx, name: str) -> List[Tuple[int, int]]:
    if ctx.trace is None or not ctx.window.span_steps:
        return []
    return [(s, e) for n, s, e in ctx.trace.host if n == name]


def _union(intervals) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _overlap(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """The length of the intersection of two sorted disjoint lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def step_idle_pct(ctx) -> Optional[float]:
    """The share of the profiled span (first device operation's start to
    the last one's end) in which no device operation ran while the host
    was inside ``avsiam.step``."""
    steps = _spans(ctx, STEP)
    if not steps or ctx.trace.span_s() <= 0:
        return None
    busy = ctx.trace.busy_intervals()
    lo, hi = busy[0][0], busy[-1][1]
    idle = [(busy[k][1], busy[k + 1][0]) for k in range(len(busy) - 1)]
    inside = _union((max(s, lo), min(e, hi)) for s, e in steps if e > lo
                    and s < hi)
    return 100.0 * _overlap(idle, inside) / (hi - lo)
