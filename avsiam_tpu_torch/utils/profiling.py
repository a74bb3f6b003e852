"""Profiling: the port's one tracing module. A device trace of a region,
named host spans, device phases inside CUDA graphs, the capture counters
and the card's memory statistics.

Counterpart of ``avsiam_tpu/utils/profiling.py``:

- ``trace(logdir)`` runs the enclosed region under ``torch.profiler``
  (the host and, where there is a card, the device) and writes one Chrome
  trace file (``trace_<time>.json``, for chrome://tracing or Perfetto)
  under ``logdir``;
- ``annotate(name)``: a named host span. While a torch profiler records it
  is ``record_function(name)``, a kineto host event on the device trace's
  clock; otherwise it is one shared no-op context, so a span costs one
  check and creates no op. The program's spans are named ``avsiam.*``;
- ``PhaseMarks``: stamps of the card's clock captured into a CUDA graph
  (``csrc/stamp.cu``), which each replay writes again on the device with
  no host work; ``ms()`` gives the device ms of each phase of the last
  replay;
- ``COUNTERS``: the graph captures made in this process and their host
  seconds (written by ``train/graphs.py:Captures.capture``);
- ``device_memory_stats``: the card's bytes in use, their peak and the
  card's total; None on the CPU.

The JAX package's ``StepTimer`` has no counterpart: the loops keep their
own per-sample meters (``train/loops.py``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# written only by ``Captures.capture``: how many graphs were captured and
# the host seconds they took in all (each with its sync and empty_cache)
COUNTERS: Dict[str, float] = {"graph.captures": 0, "graph.capture_s": 0.0}

_NO_SPAN = contextlib.nullcontext()


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
    """A named host span: ``record_function(name)`` while a torch profiler
    records on this thread, else a shared no-op context."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _NO_SPAN


def no_mark(name: str) -> None:
    """The mark of a body run without ``PhaseMarks``: nothing."""


class PhaseMarks:
    """Device phases of one CUDA graph.

    ``mark(name)`` captures a stamp of the card's nanosecond clock into the
    next slot of the marks' buffer while the current stream is being
    captured, and does nothing elsewhere (on the CPU, in an eager warm-up).
    The stamp is a one-thread kernel (``csrc/stamp.cu``), so each replay
    writes it again once the work before it has ended. A phase runs from
    one mark to the next and is named by the mark that ends it. (Timing
    events captured as event-record nodes read the same phases, but made
    the graph's launch slower while the card was busy.)

    ``device``: the card whose graph is marked. The buffer is allocated
    there at once, outside any capture: a graph's pool may be shared, and
    a later graph of the pool may reuse the memory an earlier one frees
    while it runs. Without a card (None, or the CPU) nothing is marked."""

    SLOTS = 32

    def __init__(self, device=None):
        self.names: List[str] = []
        self.stamps: Optional[torch.Tensor] = None
        if device is not None and torch.device(device).type == "cuda":
            self.stamps = torch.empty(self.SLOTS, dtype=torch.int64,
                                      device=device)

    def mark(self, name: str) -> None:
        if (self.stamps is None
                or not torch.cuda.is_current_stream_capturing()):
            return
        if len(self.names) == self.SLOTS:
            raise ValueError(f"a graph holds at most {self.SLOTS} marks")
        from avsiam_tpu_torch import kernels
        kernels.check(kernels.library().avsiam_phase_stamp(
            self.stamps.data_ptr(), len(self.names),
            kernels.stream_handle(self.stamps)), "phase_stamp")
        self.names.append(name)

    def ms(self) -> Dict[str, float]:
        """{phase: device ms} of the graph's last replay, in order, once
        that replay has ended; {} where nothing was marked."""
        if len(self.names) < 2:
            return {}
        torch.cuda.synchronize(self.stamps.device)
        ns = self.stamps[:len(self.names)].tolist()
        return {name: (b - a) / 1e6 for name, a, b in
                zip(self.names[1:], ns, ns[1:])}


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
