"""What every cell shares: finding a cell's files by name, the measured
window, the profiled span, the readers of the metrics and the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its files:

- the configuration, the file its ``configs`` entry names
  (``portbench/configs/<config>.json``): the model's sizes and impls;
- the traffic, ``portbench/traffic/<traffic>.json``: the job, the batch,
  the recipe's settings and the ring of inputs;
- the cell's own file, ``portbench/cells/<workload>.json``: the limits of
  the numbers that decide ``correct``, and under ``not_compared`` any
  number the cell does not compare, with the reason;
- the job module, ``portbench/jobs/<job>.py``, named by the traffic;
- one reader a quantity, ``portbench/end_to_end/<stem>.py`` and
  ``portbench/metrics/<stem>.py``, where the stem is the metric's name up
  to its first dot (``mfu.pretrain`` and ``mfu.finetune`` share
  ``mfu.py``), each with ``read(ctx)`` returning a number or None (nothing
  to read in this cell: the metric is left out).

A later cell, configuration, traffic or metric is a new file and a new
entry in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "avsiam_tpu")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, bench_path: Path = ROOT / "BENCHMARK.json"):
    """The cell named ``workload``: its entry, configuration, traffic,
    limits, and the entries of the metrics it reports."""
    bench = load_json(bench_path)
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in {bench_path.name}")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])

    def reports(metric, moves_ok=None):
        cells = metric.get("workloads")
        if cells is not None:
            return workload in cells
        return moves_ok is None or moves_ok(metric["moves"])

    e2e = [m for m in bench["end_to_end"] if reports(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if reports(m, lambda moves: moves in names)]
    checks = load_json(HERE / "cells" / f"{workload}.json")
    return SimpleNamespace(
        name=workload, entry=entry, chips=entry["chips"],
        config=load_json(ROOT / config["file"]),
        traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=checks["limits"], not_compared=checks.get("not_compared", {}),
        end_to_end=e2e, per_layer=per_layer,
        run_seconds=bench["run_seconds"])


def load_job(name: str):
    return load_module(HERE / "jobs" / f"{name}.py")


def reader(folder: str, name: str) -> Path:
    """The reader of metric ``name``: its name up to the first dot."""
    return HERE / folder / f"{name.split('.', 1)[0]}.py"


def read_metrics(entries: List[dict], folder: str, ctx) -> Dict[str, dict]:
    """{name: {'value', 'unit'}} of every entry whose reader reads a number
    in this run."""
    out = {}
    for m in entries:
        value = load_module(reader(folder, m["name"])).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def process_start() -> float:
    """The wall-clock time this process started, from /proc."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """The modules loaded in this process whose top-level name, compared
    whole, is JAX's, flax's, optax's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between closest ranks."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def run_window(job, seconds: float, trace: bool) -> SimpleNamespace:
    """Step ``job`` for ``seconds`` on the card and time it.

    The window starts on a recorded event after a sync and ends on a sync
    after the last step of the first whole block of ``job.block`` steps
    to end past ``seconds`` (a finetune block holds the route mix, so every
    seed's window holds the same work in another order); its rate is all
    the clips stepped over all of its time. An event recorded after each step gives each step's time (from
    the previous step's end to its own), and the host waits on the event
    two steps back before it issues the next, so it never runs far ahead
    and no step ends in a sync of its own. The host's time inside each
    step call (the copies into the graph's inputs, the replay) is kept.
    With ``trace``, a span of ``job.profile_steps`` whole steps, starting
    at a multiple of ``job.block`` past the window's middle, runs under
    torch.profiler; ``profiler_s`` is the host time its start and stop
    took (with a sync each), which the window's rates leave out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    events: List[torch.cuda.Event] = []
    host_ms: List[float] = []
    prof, span_steps, profiler_s = None, None, 0.0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    i = 0
    while time.perf_counter() - t0 < seconds or i % job.block:
        if (trace and span_steps is None and i % job.block == 0
                and time.perf_counter() - t0 >= seconds / 2):
            p0 = time.perf_counter()
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
            span_steps = list(range(i, i + job.profile_steps))
            profiler_s += time.perf_counter() - p0
        if len(events) >= 2:
            events[-2].synchronize()
        h = time.perf_counter()
        job.step(i)
        host_ms.append((time.perf_counter() - h) * 1e3)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        i += 1
        if prof is not None and span_steps and i == span_steps[-1] + 1:
            p0 = time.perf_counter()
            torch.cuda.synchronize()
            prof.stop()
            profiler_s += time.perf_counter() - p0
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    if prof is not None and i <= span_steps[-1]:
        prof.stop()  # the window closed inside the span: a shorter span
        span_steps = span_steps[:i - span_steps[0]]
    step_ms = [start.elapsed_time(events[0])] + [
        events[k - 1].elapsed_time(events[k]) for k in range(1, len(events))]
    return SimpleNamespace(steps=i, seconds=window_s, step_ms=step_ms,
                           host_ms=host_ms, prof=prof, span_steps=span_steps,
                           profiler_s=profiler_s)


def device_info(chips: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips))}


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def summarize(values: List[float]) -> str:
    return (f"median {statistics.median(values):.4f} p90 "
            f"{percentile(values, 90):.4f} n {len(values)}")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(result: dict) -> None:
    print(json.dumps(result), flush=True)

