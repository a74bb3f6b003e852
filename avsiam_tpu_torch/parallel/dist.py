"""Multi-process runtime helpers over ``torch.distributed``.

Counterpart of ``avsiam_tpu/parallel/dist.py`` (the reference's NCCL
plumbing: src/utils.py:206-218,250-299 ``init_distributed_mode`` and
rank-0 printing; src/traintest_ft_base.py:22-27 ``distributed_concat``).
Each process drives one card (or, under ``AVSIAM_PLATFORM=cpu``, the CPU)
and holds the whole model; the batch is split over the processes in
contiguous rank blocks (``data/samplers.py``).

A process group exists only where ``initialize_multihost`` made one: under
torchrun (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), even with one process, or with the JAX-named flags
asking for more than one. Without it ``active()`` is false, and every
caller takes its single-process path, with no collective.
"""

from __future__ import annotations

import builtins
import os
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# elements of one flat all-reduce bucket (256 MiB of float32)
BUCKET_NUMEL = 1 << 26


def active() -> bool:
    """True where a process group is up."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def is_main_process() -> bool:
    return rank() == 0


def _platform_cpu() -> bool:
    return os.environ.get("AVSIAM_PLATFORM", "").strip().lower() == "cpu"


def group_device() -> torch.device:
    """The device the group's collectives take their tensors on: the bound
    card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> dict:
    """Initialise ``torch.distributed`` where the run asks for it, and
    describe the world.

    Under torchrun (its environment: ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``, and ``LOCAL_RANK``) the group is
    made from that environment, whatever its size; flags that name another
    world are refused. Otherwise the JAX-named flags: ``num_processes`` > 1
    needs ``coordinator_address`` (host:port of process 0) and
    ``process_id``. With neither this is a no-op and no group exists.
    The backend is NCCL, each process bound to ``cuda:LOCAL_RANK`` (0 where
    the variable is unset), or gloo under ``AVSIAM_PLATFORM=cpu``. A group
    that fails to come up raises: the run never carries on as one process.
    Returns the keys of the JAX function; each process drives one
    device."""
    if not active():
        torchrun = all(v in os.environ for v in TORCHRUN_VARS)
        if torchrun:
            world, pid = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
            asked = {"--num_processes": (num_processes, world),
                     "--process_id": (process_id, pid)}
            wrong = [f"{k} {v}" for k, (v, want) in asked.items()
                     if v is not None and v != want]
            if wrong:
                raise SystemExit(
                    f"{', '.join(wrong)} does not match the world torchrun "
                    f"made (WORLD_SIZE={world}, RANK={pid})")
            init = "env://"
        else:
            world = 1 if num_processes is None else num_processes
            pid = 0 if process_id is None else process_id
            if world > 1 and (coordinator_address is None
                              or process_id is None):
                raise SystemExit(
                    f"--num_processes {world} does not match the world of 1 "
                    f"process: a world of {world} needs "
                    f"--coordinator_address and --process_id, or torchrun's "
                    f"environment")
            if world < 1 or not 0 <= pid < world:
                raise SystemExit(f"--process_id {pid} is outside the world "
                                 f"of --num_processes {world}")
            init = f"tcp://{coordinator_address}"
        if torchrun or world > 1:
            if _platform_cpu():
                backend, device_id = "gloo", None
            else:
                from avsiam_tpu_torch.device import resolve_device
                resolve_device("cuda")
                local = int(os.environ.get("LOCAL_RANK", "0"))
                torch.cuda.set_device(local)
                backend, device_id = "nccl", torch.device("cuda", local)
            dist.init_process_group(backend, init_method=init,
                                    world_size=world, rank=pid,
                                    device_id=device_id)
    return {"process_index": rank(), "process_count": world_size(),
            "local_devices": 1, "global_devices": world_size()}


def setup_rank0_printing(force: bool = False):
    """Rank-0-only printing via a ``builtins.print`` wrap (utils.py:206-218).

    The wrap is installed on every rank, as the reference does, so
    ``print(..., force=True)`` is valid everywhere: the main process prints
    everything, the others only forced messages."""
    # idempotent: a second call must not nest wrappers, or the outer wrap
    # would pop force=True and forward force=False to the inner one,
    # silencing forced messages on the other ranks
    builtin_print = getattr(builtins.print, "_avsiam_inner", builtins.print)
    main = is_main_process()

    def print_rank0(*args, **kwargs):
        if kwargs.pop("force", False) or force or main:
            builtin_print(*args, **kwargs)

    print_rank0._avsiam_inner = builtin_print
    builtins.print = print_rank0


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    """[n, ...] on each process -> [world * n, ...], in rank order."""
    out = t.new_empty((world_size() * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous())
    return out


def gather_batch(tensors: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor's slabs of all processes, concatenated in rank order
    (every process gives the same shapes): the global batch from the
    processes' blocks."""
    return [_all_gather(t) for t in tensors]


def gather_eval_outputs(local_array: np.ndarray, total: int) -> np.ndarray:
    """Ordered cross-process gather and trim for evaluation.

    Each rank evaluated its contiguous padded slab (``eval_shard_indices``);
    the slabs, of equal size, are concatenated in rank order, which restores
    dataset order, and cut to the true size ``total`` (``distributed_concat``,
    traintest_ft_base.py:22-27)."""
    local = np.asarray(local_array)
    if world_size() == 1:
        return local[:total]
    dev = group_device()
    shape = torch.tensor(local.shape, device=dev)
    shapes = _all_gather(shape[None])
    if not bool((shapes == shape).all()):
        raise ValueError(f"the ranks' slabs differ in shape: "
                         f"{shapes.tolist()}")
    gathered = _all_gather(torch.from_numpy(np.ascontiguousarray(local))
                           .to(dev))
    return gathered.cpu().numpy()[:total]


def average_across_processes(values: Dict[str, float]) -> Dict[str, float]:
    """Cross-process mean of a dict of scalar metrics (the reference's meter
    all-reduce, utils.py:40-51): the keys sorted, one float32 vector, one
    all-reduce. Checkpoint decisions keyed on these metrics are then the
    same on every process. One process: the values as they are."""
    if world_size() == 1:
        return dict(values)
    keys = sorted(values)
    vec = torch.tensor([float(values[k]) for k in keys], dtype=torch.float32,
                       device=group_device())
    dist.all_reduce(vec)
    mean = (vec / world_size()).tolist()
    return {k: mean[i] for i, k in enumerate(keys)}


def barrier(name: str = "barrier"):
    """Cross-process sync point (utils.py barrier parity); ``name`` is for
    the reader, as in the JAX package."""
    if active():
        dist.barrier()


def all_reduce_mean_(tensors: Iterable[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the processes, in place: flat
    buckets of at most ``BUCKET_NUMEL`` elements in the given order, which
    must be the same on every process, one all-reduce (sum) a bucket, then
    divided by the world size. Every tensor of one call has one dtype. No
    host sync: a CUDA graph may capture it."""
    world = world_size()
    bucket: List[torch.Tensor] = []
    numel = 0

    def flush():
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat)
        flat.div_(world)
        for t, piece in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(piece.view_as(t))

    for t in tensors:
        if bucket and numel + t.numel() > BUCKET_NUMEL:
            flush()
            bucket, numel = [], 0
        bucket.append(t)
        numel += t.numel()
    if bucket:
        flush()


def broadcast_from_main_(tensors: Iterable[torch.Tensor]) -> None:
    """Overwrite each tensor with rank 0's, in place (the given order must
    be the same on every process), outside autograd."""
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0)
