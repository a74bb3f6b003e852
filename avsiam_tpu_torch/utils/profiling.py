"""Profiling: a device trace of a region, named spans, the step-time meters
and the card's memory statistics.

Counterpart of ``avsiam_tpu/utils/profiling.py``:

- ``trace(logdir)`` runs the enclosed region under ``torch.profiler``
  (the host and, where there is a card, the device) and writes one Chrome
  trace file (``trace_<time>.json``, for chrome://tracing or Perfetto)
  under ``logdir``;
- ``annotate(name)``: a named span inside a trace
  (``torch.profiler.record_function``);
- ``StepTimer``: the reference's per-sample total, data and compute
  meters;
- ``device_memory_stats``: the card's bytes in use, their peak and the
  card's total; None on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from avsiam_tpu_torch.eval.metrics import AverageMeter


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed region; its Chrome trace is written under
    ``logdir`` when the region ends. Yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}.json"))


def annotate(name: str):
    """A named span inside a trace."""
    return record_function(name)


class StepTimer:
    """per_sample_time / per_sample_data_time / per_sample_dnn_time meters
    (traintest_cavmae_base.py:38,118-120): ``data_ready`` when the batch is
    in hand, ``step_done`` after the step, each with the batch size."""

    def __init__(self):
        self.per_sample_time = AverageMeter()
        self.per_sample_data_time = AverageMeter()
        self.per_sample_dnn_time = AverageMeter()
        self._end = time.time()
        self._dnn_start = None

    def data_ready(self, batch_size: int):
        now = time.time()
        self.per_sample_data_time.update((now - self._end) / batch_size)
        self._dnn_start = now

    def step_done(self, batch_size: int):
        now = time.time()
        self.per_sample_time.update((now - self._end) / batch_size)
        if self._dnn_start is not None:
            self.per_sample_dnn_time.update(
                (now - self._dnn_start) / batch_size)
        self._end = now

    def summary(self) -> Dict[str, float]:
        return {
            "per_sample_time": self.per_sample_time.avg,
            "per_sample_data_time": self.per_sample_data_time.avg,
            "per_sample_dnn_time": self.per_sample_dnn_time.avg,
        }


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """{'bytes_in_use', 'peak_bytes_in_use', 'bytes_limit'} of the card
    (``device``, the current one when None): the bytes the caching
    allocator has handed out now and at most since the process began (or
    the last ``torch.cuda.reset_peak_memory_stats``), and the card's total
    memory. None for the CPU or where there is no card."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.cuda.current_device()
    device = torch.device(device)  # an int is a card's index
    if device.type != "cuda":
        return None
    return {"bytes_in_use": torch.cuda.memory_allocated(device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
            "bytes_limit": torch.cuda.mem_get_info(device)[1]}
