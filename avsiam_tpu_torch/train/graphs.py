"""CUDA graphs: the port's counterpart of the JAX package's ``jax.jit``.

The JAX package compiles each training and eval step into one device
program (``avsiam_tpu/train/pretrain.py:120,139``,
``avsiam_tpu/train/finetune.py:132,145``, ``avsiam_tpu/cli/retrieval.py:
46-49``). The port captures the same work once into a CUDA graph and
replays it, so the host pays one launch a step in place of one an op. The
pieces every graphed step and forward share:

- ``available``: whether a caller's device takes the graphed forms (the
  card, without a tensor-parallel model axis, whose collectives no graph
  holds yet);
- ``warm_up``: a call run eagerly on a side stream (torch's whole-network
  capture recipe), which brings into being what must exist before a
  capture: Adam's state, cuBLAS's handles, the kernel library;
- ``Captures``: the capture itself, thread-local (a data loader's worker
  may copy to the card meanwhile), into one memory pool that a step's
  graphs and its forwards can share, with the kernel launches the capture
  counted (a replay adds them to ``kernels.LAUNCHES``), each capture
  counted with its host seconds in ``profiling.COUNTERS``; after a failed
  capture every later call raises, and nothing runs eagerly in its place;
- ``GraphedForward``: a forward under ``torch.no_grad()`` bound to one
  model, one graph per input signature, as ``jax.jit`` keeps one program
  per shape.

Sharing a pool is safe because every tensor that lives across replays
stays outside it (parameters, gradients where a step keeps them, Adam's
state, the static inputs and a step's static loss), and a forward's
outputs, which live in it, are cloned right after their replay, before any
other graph of the pool runs.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import torch

from avsiam_tpu_torch import kernels
from avsiam_tpu_torch.parallel import dist as pdist
from avsiam_tpu_torch.utils import profiling


def available(device) -> bool:
    """Whether the steps and forwards run as CUDA graphs on ``device``:
    on the card, and not under a tensor-parallel model axis."""
    return torch.device(device).type == "cuda" and pdist.model_size() == 1


def pool_for(device):
    """A new graph memory pool for the graphs of a run on ``device``
    (``torch.cuda.graph_pool_handle``), or None where ``available`` says
    no graph runs."""
    return torch.cuda.graph_pool_handle() if available(device) else None


def pool_bytes(pool) -> int:
    """The bytes the graph memory pool ``pool`` (a handle, as
    ``Captures.pool`` holds it) keeps reserved on the card
    (``torch.cuda.memory_snapshot``'s segments of that pool): what its
    graphs hold between their replays."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


# one capture stream a device, made at its first capture
_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def capture_stream(device) -> torch.cuda.Stream:
    """The stream every capture on ``device`` runs on. One for the
    process, as torch's default capture stream is, because the allocator
    hands a freed block of a pool back only to allocations on the block's
    stream: graphs that share a pool must be captured on one stream to
    reuse each other's blocks. Taken from torch's high-priority stream
    pool, unlike that default: it and every loader's stream come from the
    low-priority pool, which hands out its 32 streams in turn, so a
    loader's stream could be the capturing one, and the worker's copies
    and events would land in the graph."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index, priority=-1)
    return _CAPTURE_STREAMS[index]


def _tensors(x):
    """The tensors of ``x``: a tensor, a tuple, list or dict of them, or a
    ``MaskDraws``."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in _tensors(item)]
    return [t for t in x.tensors() if t is not None]


def _clone(x):
    """A copy of ``x`` (as ``_tensors`` reads it) in new tensors."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x.map(torch.clone)


def _signature(x):
    """The shapes and dtypes of ``x``'s tensors: a graph takes inputs of
    its capture's signature only."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    return (type(x).__name__, getattr(x, "block", None),
            tuple(None if t is None else (tuple(t.shape), t.dtype)
                  for t in x.tensors()))


def warm_up(fn: Callable, device):
    """``fn()`` run eagerly on a side stream, which the current stream then
    waits for; its output tensors are marked as used on the current
    stream."""
    with profiling.annotate("avsiam.graph.warm_up"):
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = fn()
        current.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(current)
        return out


class Captures:
    """What a graphed step or forward keeps about its captures: its name
    (``what``, for the errors), its memory pool (``pool``: a handle of
    ``torch.cuda.graph_pool_handle`` shared with others, or None for a
    pool of its own, made at its first capture) and its failed capture,
    if any."""

    def __init__(self, what: str, pool=None):
        self.what = what
        self.pool = pool
        self.failed: Optional[BaseException] = None

    def refuse_after_failure(self) -> None:
        if self.failed is not None:
            raise RuntimeError(f"{self.what} failed to capture") \
                from self.failed

    def capture(self, fn: Callable, device
                ) -> Tuple[torch.cuda.CUDAGraph, object, Dict[str, int]]:
        """``fn`` captured once into a new graph in the pool, with the
        eager blocks cached beside it released first: (the graph, ``fn``'s
        output, the kernel launches the capture counted). The graph has
        not run yet. A failed capture raises, then and at every later
        call (``refuse_after_failure``). A capture that succeeds adds one
        to ``profiling.COUNTERS['graph.captures']`` and its host seconds,
        from the sync and ``empty_cache`` before it to the graph's
        instantiation, to ``['graph.capture_s']``."""
        with profiling.annotate("avsiam.graph.capture"):
            t0 = time.perf_counter()
            out = self._new_graph(fn, device)
            profiling.COUNTERS["graph.captures"] += 1
            profiling.COUNTERS["graph.capture_s"] += time.perf_counter() - t0
            return out

    def _new_graph(self, fn: Callable, device):
        if pdist.active():
            # the communicator must exist before a capture starts: its
            # creation cannot be captured
            pdist.all_reduce_mean_([torch.zeros(1, device=device)])
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        before = dict(kernels.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        stream = capture_stream(device)
        try:
            # thread-local: another thread may use the card meanwhile (the
            # data loader's worker pins batches and copies them on its own
            # stream, NCCL's watchdog polls); in the default global mode
            # its calls would invalidate the capture
            with torch.cuda.graph(graph, pool=self.pool, stream=stream,
                                  capture_error_mode="thread_local"):
                out = fn()
        except BaseException as err:
            self.failed = err
            if not isinstance(err, Exception):
                raise
            raise RuntimeError(f"capturing {self.what} in a CUDA graph "
                               f"failed") from err
        if self.pool is None:
            self.pool = graph.pool()
        return graph, out, {k: kernels.LAUNCHES[k] - n
                            for k, n in before.items()}


class GraphedForward(Captures):
    """``fn(model, *inputs)`` under ``torch.no_grad()`` as CUDA graphs,
    bound to the model of the first call.

    The first call runs ``fn`` eagerly, as the warm-up. Each later call
    whose inputs have a signature (shapes and dtypes) not seen since
    captures a graph for it, with static copies of its inputs, and replays
    it; a call of a known signature copies its inputs into that graph's
    static copies and replays it. Each replay adds its capture's launch
    counts to ``kernels.LAUNCHES``. Outputs come back as clones.

    No fallback: it raises for a model off the card, under a model axis,
    for another model than the first call's, for inputs off the model's
    device, and after a failed capture."""

    def __init__(self, fn: Callable, what: str, pool=None):
        super().__init__(what, pool)
        self.fn = fn
        self.model: Optional[torch.nn.Module] = None
        # signature -> (static inputs, graph, outputs, launches a replay)
        self.graphs: Dict[tuple, tuple] = {}

    def _run(self, model, inputs):
        with torch.no_grad():
            return self.fn(model, *inputs)

    def __call__(self, model: torch.nn.Module, *inputs):
        with profiling.annotate("avsiam.forward"):
            return self._call(model, inputs)

    def _call(self, model: torch.nn.Module, inputs):
        self.refuse_after_failure()
        device = next(model.parameters()).device
        first = self.model is None
        if first:
            if device.type != "cuda":
                raise RuntimeError(
                    f"{self.what} as a CUDA graph needs a CUDA device, not "
                    f"{device}: run its eager form on the CPU")
            if pdist.model_size() > 1:
                raise ValueError(
                    f"a model axis of {pdist.model_size()}: {self.what} "
                    f"runs eagerly under tensor parallelism")
        elif model is not self.model:
            raise ValueError(f"{self.what} runs only the model of its "
                             f"first call")
        if any(t.device != device for x in inputs for t in _tensors(x)):
            raise ValueError(f"inputs of {self.what} off the model's "
                             f"device {device}")
        if first:
            self.model = model
            return warm_up(lambda: self._run(model, inputs), device)
        sig = tuple(_signature(x) for x in inputs)
        entry = self.graphs.get(sig)
        if entry is None:
            static = [_clone(x) for x in inputs]
            graph, out, launches = self.capture(
                lambda: self._run(model, static), device)
            entry = self.graphs[sig] = (static, graph, out, launches)
        else:
            for s, x in zip(entry[0], inputs):
                s.copy_(x)
            kernels.add_launches(entry[3])
        entry[1].replay()
        return _clone(entry[2])
