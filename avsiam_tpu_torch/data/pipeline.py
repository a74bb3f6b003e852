"""Input pipeline: host batches assembled on a background thread, copied to
the card on a side stream, and transformed there.

Counterpart of ``avsiam_tpu/data/pipeline.py``:

* ``Prefetcher``: one worker thread and a bounded queue, the JAX package's
  design. An error in the worker reaches the consumer; the end marker
  arrives even when the queue is full; ``close()`` unblocks a worker that
  the consumer left early.
* ``host_batches``: NumPy batches of an ``AVDataset``, the per-sample
  streams keyed on (seed, epoch position).
* ``device_loader``: the worker pins each host batch and issues its copy to
  the device on a side stream (non-blocking), recording an event there; the
  consumer's stream waits on that event before the transform reads the
  batch. Each train batch's draws (``ops/augment.py:draw_transform``) come
  from a generator keyed on (draw seed, batch index), the counterpart of
  ``jax.random.fold_in(rng_key, i)``.

Under a process group (``parallel/dist.py``) each process loads its block
of every global batch, and a train batch's draws are the global batch's,
of which it takes its block's rows, so the processes' batches together are
the one-process batch. The mixup partners (``TransformDraws.perm``) index
the global batch: where mixup is on, the processes' raw batches are
gathered in rank order, and each takes its partners from the gathered one.
JAX gets this for free, its transform running on the global sharded
array.

Tracing (``utils/profiling.py``): each device transform is an
``avsiam.data.transform`` span; the worker thread's host batch and pinned
copy show in the consumer's ``avsiam.loop.data_wait`` span.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from avsiam_tpu_torch.ops.augment import TransformDraws, draw_transform
from avsiam_tpu_torch.parallel import dist as pdist
from avsiam_tpu_torch.utils import profiling


class Prefetcher:
    """Iterate ``it`` on a worker thread, ``depth`` items ahead, each item
    passed through ``put`` (if given) on that thread."""

    _DONE = object()

    def __init__(self, it: Iterable, put: Optional[Callable] = None,
                 depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def offer(item) -> None:
            # a bounded put that notices close(): a consumer that stops
            # early would otherwise leave this thread blocked for good
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def worker():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    offer(item if put is None else put(item))
            except BaseException as e:  # noqa: BLE001 - raised to the consumer
                self._err = e
            finally:
                # the end marker must reach the consumer even when the queue
                # is full, unless close() said nobody is listening
                offer(self._DONE)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def close(self) -> None:
        """Unblock and stop the worker; drop the queued items."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def host_batches(dataset, index_batches, seed: int,
                 frames_per_sample: int = 1,
                 position_batches=None) -> Iterator:
    """NumPy batches (wav, frames u8, labels, wav_len) of ``dataset`` over
    ``index_batches``. The int seed goes through, so the dataset derives
    each sample's stream from (seed, epoch position): batches do not depend
    on rank sharding or assembly order, and repeated draws of one index
    get independent streams (``AVDataset._sample_rng``)."""
    if position_batches is None:
        for idx in index_batches:
            yield dataset.batch(idx, seed,
                                frames_per_sample=frames_per_sample)
    else:
        for idx, pos in zip(index_batches, position_batches):
            yield dataset.batch(idx, seed,
                                frames_per_sample=frames_per_sample,
                                positions=pos)


def batch_generator_seed(draw_seed: int, i: int) -> int:
    """The seed of batch i's draw generator, keyed on (draw seed, i)."""
    return int(np.random.SeedSequence([int(draw_seed), int(i)])
               .generate_state(1, dtype=np.uint64)[0] >> 1)


class DeviceBatch:
    """A host batch on its way to the device: the device tensors, the event
    after their copy (None on the CPU) and the pinned host tensors, kept
    alive until the copy has run."""

    def __init__(self, host, device: torch.device,
                 stream: Optional[torch.cuda.Stream]):
        tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in host]
        self.event = None
        if device.type != "cuda":
            self.host, self.tensors = tensors, [t.to(device) for t in tensors]
            return
        self.host = [t.pin_memory() for t in tensors]
        with torch.cuda.stream(stream):
            self.tensors = [t.to(device, non_blocking=True)
                            for t in self.host]
            self.event = torch.cuda.Event()
            self.event.record(stream)

    def ready(self):
        """The device tensors, once the consuming stream has waited for
        their copy; their memory is marked in use by that stream."""
        if self.event is None:
            return self.tensors
        current = torch.cuda.current_stream(self.tensors[0].device)
        current.wait_event(self.event)
        for t in self.tensors:
            t.record_stream(current)
        return self.tensors


def device_loader(dataset, index_batches, transform: Callable,
                  draw_seed: int, seed: int = 0, frames_per_sample: int = 1,
                  device="cuda", train: bool = True,
                  position_batches=None) -> Iterator:
    """Host batches -> pinned copies to ``device`` on a side stream ->
    ``transform`` on the device. Yields (fbank, image, labels).

    Train: batch i's draws come from a generator on ``device`` seeded with
    ``batch_generator_seed(draw_seed, i)`` and go to ``transform(draws,
    wav, frames, labels, wav_len)``; eval: ``transform(wav, frames, labels,
    wav_len)``. ``seed`` keys the host's per-sample streams. Under a
    process group the index batches are this replica's blocks (the data
    axis's: the ranks of a model group load the same block), the draws
    are made for the global batch and cut to the block, and with mixup on
    the transform also takes ``partners``, the (wav, frames, labels) of
    each row's partner, from the replicas' gathered batches."""
    device = torch.device(device)
    world, rank = pdist.data_size(), pdist.data_rank()
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    it = Prefetcher(
        host_batches(dataset, index_batches, seed, frames_per_sample,
                     position_batches),
        put=lambda host: DeviceBatch(host, device, stream))

    def transformed(i, batch):
        if not train:
            return transform(*batch)
        gen = torch.Generator(device=device)
        gen.manual_seed(batch_generator_seed(draw_seed, i))
        b = batch[0].shape[0]
        draws = draw_transform(dataset.audio_conf, b * world, gen)
        if not pdist.active():
            return transform(draws, *batch)
        draws = TransformDraws(*(t[rank * b:(rank + 1) * b] for t in draws))
        partners = None
        if dataset.audio_conf.mixup > 0:
            partners = tuple(g[draws.perm]
                             for g in pdist.gather_batch(batch[:3]))
        return transform(draws, *batch, partners=partners)

    try:
        for i, item in enumerate(it):
            batch = item.ready()
            with profiling.annotate("avsiam.data.transform"):
                out = transformed(i, batch)
            yield out
    finally:
        # reached at the end and when the consumer breaks early: stops the
        # worker instead of leaving it blocked on a full queue
        it.close()
