"""Row gathers over tokens and over the batch.

Counterpart of ``avsiam_tpu/ops/gather.py``. The JAX package lowers these to
one-hot GEMMs on the TPU (a gather's scatter-add backward is slow there); on
the GPU an index gather is the natural form. Out-of-range ids are clamped,
as JAX's ``mode="clip"`` does: ``torch.gather`` would raise on them.
"""

from __future__ import annotations

import torch


def take_tokens(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x [N, L, D], ids [N, K] -> [N, K, D] with out[n, k] = x[n, ids[n, k]]."""
    ids = ids.clamp(0, x.shape[1] - 1)
    return torch.gather(x, 1, ids[:, :, None].expand(-1, -1, x.shape[2]))


def take_batch(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x [B, ...], ids [S] -> [S, ...] with out[s] = x[ids[s]]."""
    return x.index_select(0, ids.clamp(0, x.shape[0] - 1))
