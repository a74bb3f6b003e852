"""Experiment logging: JSONL metrics and, where it is set up, wandb.

Counterpart of ``avsiam_tpu/utils/logging.py``: ``MetricsLogger`` appends
one JSON object a call to ``{exp_dir}/metrics.jsonl``, and attaches wandb
only when the package is importable and ``WANDB_PROJECT`` is set (hosts
with no network get the JSONL alone). ``main_process`` is True unless the
caller says otherwise: under data parallelism the loops pass rank 0's
flag, and another process's logger writes nothing.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, exp_dir: str, project: str = "avsiam-tpu",
                 enable_wandb: Optional[bool] = None,
                 main_process: bool = True):
        self._main = main_process
        self._f = None
        self._t0 = time.time()
        self._wandb = None
        if not self._main:
            return
        os.makedirs(exp_dir, exist_ok=True)
        self._f = open(os.path.join(exp_dir, "metrics.jsonl"), "a")
        if enable_wandb is None:
            enable_wandb = bool(os.environ.get("WANDB_PROJECT"))
        if enable_wandb:
            try:
                import wandb
            except ImportError:
                return
            self._wandb = wandb
            wandb.init(project=os.environ.get("WANDB_PROJECT", project))

    def log(self, metrics: Dict, step: Optional[int] = None):
        if not self._main:
            return
        row = {"t": round(time.time() - self._t0, 3), **metrics}
        if step is not None:
            row["step"] = step
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
