"""The arithmetic of the metrics' readers (``end_to_end/*.py``,
``metrics/*.py``). The per-layer readers take their counts from the cell's
job (``ctx.job``); an end-to-end rate names the job whose clips it counts.
Where the run has nothing for a reader (another job, no trace, no device
time in a family), it reads None and the metric is left out.

``ctx``: ``job`` (the job module, with its counts), ``window`` (steps,
seconds, each step's ms by CUDA events, each step call's host ms, the
profiled span's steps), ``trace`` (``pb_trace.Trace`` or None), ``setup_s``
and ``memory_peak_bytes``.
"""

from __future__ import annotations

import statistics
from typing import Optional

import pb_counts
import pb_harness
import pb_trace


def clips_per_s(ctx, kind: str) -> Optional[float]:
    """All clips stepped in the window over the window's whole time, in a
    cell of job ``kind``."""
    if ctx.job.kind != kind or ctx.window.steps == 0:
        return None
    return ctx.job.clips(ctx.window.steps) / ctx.window.seconds


def step_ms_p90(ctx, kind: str) -> Optional[float]:
    """The 90th percentile of every step time of the window, in a cell of
    job ``kind``."""
    if ctx.job.kind != kind or not ctx.window.step_ms:
        return None
    return pb_harness.percentile(ctx.window.step_ms, 90)


def mfu(ctx) -> Optional[float]:
    """Model operations of the window's steps over its time, less the
    profiler's start and stop, as a share of the bf16 peak (``pb_counts``:
    no rematerialised forward)."""
    if ctx.window.steps == 0:
        return None
    flops = ctx.job.model_flops(ctx.window.steps)
    seconds = ctx.window.seconds - ctx.window.profiler_s
    return 100.0 * flops / seconds / pb_counts.PEAKS["bf16_flops"]


def _span(ctx):
    if ctx.trace is None or not ctx.window.span_steps:
        return None
    return ctx.trace


def elementwise_ms(ctx) -> Optional[float]:
    """Device ms a step of everything outside the port's kernels, cuBLAS,
    NCCL and the fused Adam."""
    tr = _span(ctx)
    if tr is None:
        return None
    other = tr.group_s().get(pb_trace.OTHER)
    if other is None:
        return None
    return 1e3 * other / len(ctx.window.span_steps)


def roofline(ctx, family: str) -> Optional[float]:
    """The summed bound times of the span's calls of a kernel family
    ('attention' or 'mlp') over the family's summed device time."""
    tr = _span(ctx)
    if tr is None:
        return None
    groups = pb_trace.ATTENTION if family == "attention" else pb_trace.LN_MLP
    spent = tr.family_s(groups)
    bound = pb_counts.family_bound_s(
        ctx.job.kernel_calls(ctx.window.span_steps), family)
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent


def idle_pct(ctx) -> Optional[float]:
    """The share of the profiled span in which no device operation ran."""
    tr = _span(ctx)
    if tr is None or tr.span_s() <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.span_s())


def peak_gib(ctx) -> Optional[float]:
    return ctx.memory_peak_bytes / 2 ** 30


def replay_host_ms(ctx) -> Optional[float]:
    """The median over the window of the host's time inside a step call."""
    if not ctx.window.host_ms:
        return None
    return statistics.median(ctx.window.host_ms)
