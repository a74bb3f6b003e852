"""Sampling strategies (index generators).

The port's own copy of ``avsiam_tpu/data/samplers.py`` (which imports no
JAX; the port imports nothing of that package). Parity targets:
* ``eval_shard_indices`` — SequentialDistributedSampler
  (src/seq_dataloader.py:28-37): pad the dataset to a world-divisible size by
  repeating the LAST index, then contiguous per-rank slabs, enabling ordered
  gather + truncate evaluation.
* ``weighted_indices`` — torch WeightedRandomSampler under
  DistributedProxySampler (src/yb_sampler.py:25-39; weights CSV loaded at
  run_cavmae_ft_base.py:184-200): one deterministic GLOBAL draw with
  replacement proportional to per-sample weights, padded by wrap-around, then
  a per-rank subsample.
* ``shuffled_epoch_indices`` — torch DistributedSampler semantics: permutation
  seeded by (seed + epoch), padded by wrap-around to a world-divisible size,
  then a per-rank subsample.

Rank subsampling comes in two flavours:

* ``global_batch=None`` → torch's strided slice ``idx[rank::world]``
  (DistributedSampler/DistributedProxySampler bit-for-bit behaviour).
* ``global_batch=B`` → per-rank CONTIGUOUS block of each global batch:
  global step k covers exactly ``idx[k*B:(k+1)*B]`` with rank r loading rows
  ``[r*B/world:(r+1)*B/world]`` of it. Same disjoint-coverage guarantee as
  the strided slice, but the assembled global device batch is bit-identical
  to the single-process batch (the strided slice would interleave rows,
  permuting per-position mask RNG draws inside the step). Used by the train
  loops so losses are reproducible across world sizes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _rank_subsample(idx: np.ndarray, world: int, rank: int,
                    global_batch: Optional[int]) -> np.ndarray:
    if world == 1:
        return idx
    if global_batch is None:
        # torch DistributedSampler: indices[rank:total:num_replicas]
        return idx[rank::world]
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} is not divisible by "
                         f"the world size {world}")
    lb = global_batch // world
    nb = len(idx) // global_batch
    # rank blocks of each global batch; the global-batch tail (dropped by
    # drop_last batching anyway) is cut so every rank sees the same steps
    return idx[: nb * global_batch].reshape(nb, world, lb)[:, rank].reshape(-1)


def shuffled_epoch_indices(n: int, epoch: int, seed: int = 0,
                           world: int = 1, rank: int = 0,
                           global_batch: Optional[int] = None,
                           with_positions: bool = False):
    rng = np.random.RandomState(seed + epoch)
    idx = rng.permutation(n)
    total = -(-n // world) * world
    if total > n:
        idx = np.concatenate([idx, idx[: total - n]])
    out = _rank_subsample(idx, world, rank, global_batch)
    if not with_positions:
        return out
    # the sample's position in the GLOBAL epoch sequence — world-invariant
    # (rank subsampling slices both arrays identically), unique per draw;
    # used to key per-sample augmentation RNG so repeated draws of the same
    # dataset index (weighted sampling) get independent augmentation streams
    pos = _rank_subsample(np.arange(len(idx)), world, rank, global_batch)
    return out, pos


def weighted_indices(weights: np.ndarray, num_samples: int,
                     epoch: int, seed: int = 0, world: int = 1, rank: int = 0,
                     global_batch: Optional[int] = None,
                     with_positions: bool = False):
    """Global class-balanced draw, identical on every rank (the RNG is seeded
    only by seed+epoch), then the rank subsample — DistributedProxySampler
    (yb_sampler.py:25-39) wrapping WeightedRandomSampler."""
    rng = np.random.RandomState(seed + epoch)
    p = np.asarray(weights, dtype=np.float64)
    p = p / p.sum()
    idx = rng.choice(len(p), size=num_samples, replace=True, p=p)
    total = -(-num_samples // world) * world
    if total > num_samples:
        idx = np.concatenate([idx, idx[: total - num_samples]])
    out = _rank_subsample(idx, world, rank, global_batch)
    if not with_positions:
        return out
    pos = _rank_subsample(np.arange(len(idx)), world, rank, global_batch)
    return out, pos


def eval_shard_indices(n: int, world: int = 1, rank: int = 0) -> np.ndarray:
    """Contiguous padded slab for `rank`. After gathering rank outputs in rank
    order, truncate to n (src/traintest_ft_base.py:22-27 distributed_concat)."""
    per_rank = -(-n // world)
    total = per_rank * world
    idx = np.arange(n)
    if total > n:
        idx = np.concatenate([idx, np.full(total - n, n - 1)])
    return idx[rank * per_rank: (rank + 1) * per_rank]


def batched(indices: np.ndarray, batch_size: int,
            drop_last: bool = True) -> list:
    nb = len(indices) // batch_size if drop_last else -(-len(indices) // batch_size)
    return [indices[i * batch_size: (i + 1) * batch_size] for i in range(nb)]
