"""Readings of the correctness check at a cell's own size, on the card:
the program's over many seeds, and the control's and planted faults'. The
benchmark's runs do not run this; it sets the lower and upper readings
that the limits in ``cells/<workload>.json`` lie between.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]
        [--modes program fp8 half] [--control-seeds <k>]

For each seed it makes the cell's weights and inputs as a run does and
runs the float32 reference over the compared steps once; then, by mode:

- ``program``: the program's set-up steps (the run's compared steps,
  through the same step object and graphs), compared as a run compares
  them, without the measured window;
- ``fp8``: the control, the reference with every product's operands
  rounded to float8 e4m3 (the precision below the configuration's bf16),
  in the program's place;
- ``half``: a fault, the reference in the program's place on the first
  half of each batch alone, its mean taken over that half.

The control and the fault run on the first ``--control-seeds`` seeds
alone. A state left unchanged reads ``change_gap`` 1 by construction and
is not run. One JSON line a seed and mode.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import pb_check  # noqa: E402
import pb_harness as H  # noqa: E402


def detail(got: dict, ref: dict) -> dict:
    """Each side's losses and the replayed gradients' leaf gaps."""
    keys = set(got["replay_grads"]) | set(ref["replay_grads"])
    gaps = sorted(pb_check.leaf_gaps(got["replay_grads"], ref["replay_grads"],
                                     keys).items(), key=lambda kv: -kv[1])
    return {"losses": got["losses"], "ref_losses": ref["losses"],
            "replay_leaves": len(gaps),
            "replay_median": statistics.median(g for _, g in gaps),
            "replay_tenth": gaps[len(gaps) // 10][1],
            "replay_worst": gaps[:5]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--modes", nargs="+", default=["program", "fp8", "half"],
                   choices=("program", "fp8", "half"))
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--detail", action="store_true",
                   help="add each side's losses and the replayed steps' "
                        "leaf gaps (median, tenth worst, the worst five)")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        H.log("no CUDA device")
        return 2
    cell = H.load_cell(args.workload)
    job_mod = H.load_job(cell.traffic["job"])
    for n, seed in enumerate(args.seeds):
        t = time.time()
        modes = [m for m in args.modes
                 if m == "program" or n < args.control_seeds]
        if not modes:
            continue
        job = job_mod.Job(cell, seed, program="program" in modes)
        if job.state is not None:
            job.setup()
            job.release()
        ref = job.reference()
        for mode in modes:
            got = (job.readings if mode == "program" else
                   job.reference(fp8=mode == "fp8", half=mode == "half"))
            line = {"workload": cell.name, "seed": seed, "mode": mode,
                    **pb_check.numbers(got, ref, job.first_losses)}
            if args.detail:
                line.update(detail(got, ref))
            print(json.dumps(line), flush=True)
        H.log(f"seed {seed}: {time.time() - t:.1f} s")
        del job, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
