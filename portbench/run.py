"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It makes the weights and inputs on the card
from the seed, builds the cell's step (the kernel library is built into
``build/avsiam_tpu_torch/`` on a checkout's first run and found there
after), drives it through the steps the reference checks, measures for
``--seconds``, then checks those steps against the plain reference, and
prints one JSON line last: ``correct``, ``attempted`` (window steps),
``failed`` (window steps with a non-finite loss), ``metrics`` (the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, read from a
profiled span of the window), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each number that decides ``correct``
beside its limit, which also close standard error.

It exits 2, printing no result, without a card (or with fewer than the cell
asks for), and 3 if JAX, flax, optax or the JAX package is loaded once the
window has closed.
"""

import time

import argparse
import os
import sys
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(ROOT / "build" / "portbench_cache" / _sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(HERE), str(ROOT)]

import pb_check  # noqa: E402
import pb_harness as H  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    started = H.process_start()
    cell = H.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        H.log(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    marks = [("import", time.time())]
    job = H.load_job(cell.traffic["job"]).Job(cell, args.seed)
    torch.cuda.synchronize()
    marks.append(("model, weights, inputs", time.time()))
    job.setup()
    torch.cuda.synchronize()
    marks.append(("compared steps", time.time()))
    setup_s = marks[-1][1] - started
    H.log("set-up s: " + ", ".join(
        f"{name} {t - prev:.2f}" for (name, t), prev in
        zip(marks, [started] + [t for _, t in marks[:-1]])))
    w = H.run_window(job, args.seconds, bool(args.trace))
    device = H.device_info(cell.chips)
    trace = None
    if w.prof is not None:
        import pb_trace
        trace = pb_trace.Trace(w.prof)
        w.prof = None
    ctx = SimpleNamespace(job=job, window=w, trace=trace, setup_s=setup_s,
                          memory_peak_bytes=device["memory_peak_bytes"])
    if args.trace:
        metrics = H.read_metrics(cell.per_layer, "metrics", ctx)
    else:
        metrics = H.read_metrics(cell.end_to_end, "end_to_end", ctx)
    failed = job.failed()
    H.log(f"card: {H.power_limit()}")
    routes = getattr(job, "branches", [])
    H.log(f"window: {w.steps} steps, {w.seconds:.4f} s; step ms "
          f"{H.summarize(w.step_ms)}; host ms a call {H.summarize(w.host_ms)}"
          f"; branches {dict((b, routes.count(b)) for b in sorted(set(routes)))}")
    result = {"correct": False, "attempted": w.steps, "failed": failed,
              "metrics": metrics, "device": device}
    if trace is not None:
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.span_s()
        result["breakdown"] = {"device_ops": trace.top_ops(),
                               "idle_gaps": trace.idle_gaps()}
        H.log(f"trace: {len(w.span_steps)} steps from window step "
              f"{w.span_steps[0]}, groups (s) {trace.group_s()}")
    job.release()
    values = job.check()
    verdict = pb_check.verdict(values, cell.limits, cell.not_compared)
    for name in cell.not_compared:
        H.log(f"{name} {values[name]!r} (not compared)")
    found = H.forbidden_modules()
    if found:
        H.log(f"loaded in this process: {', '.join(found)}")
        return 3
    result["correct"] = verdict["correct"] and failed == 0
    result["checks"] = verdict["checks"]
    for name, c in verdict["checks"].items():
        H.log(f"{name} {c['value']!r} limit {c['limit']!r}")
    H.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
