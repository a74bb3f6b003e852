"""Random masking for MAE-style training, with the noise passed in.

Counterpart of ``avsiam_tpu/ops/masking.py``. Every function takes its random
numbers as tensors, so a caller can hand it draws from a ``torch.Generator``
or, in a test, the very draws JAX made.

Sorts are stable (``stable=True``), as ``jnp.argsort`` is: structured 'tf'
masking boosts more tokens to 1.1 than the ratio removes, so ties at 1.1
decide which boosted tokens stay, and an unstable sort would pick others.
"""

from __future__ import annotations

from typing import Tuple

import torch

from avsiam_tpu_torch.ops.gather import take_tokens


def len_keep_for(L: int, mask_ratio: float) -> int:
    """``int(L * (1 - mask_ratio))`` in Python float arithmetic."""
    return int(L * (1.0 - mask_ratio))


def _argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.argsort(x, dim=1, stable=True)


def _mask_from_shuffle(ids_shuffle: torch.Tensor, len_keep: int):
    N, L = ids_shuffle.shape
    ids_restore = _argsort(ids_shuffle)
    mask = torch.ones((N, L), dtype=torch.float32, device=ids_shuffle.device)
    mask[:, :len_keep] = 0.0
    mask = torch.gather(mask, 1, ids_restore)
    return ids_restore, mask


def random_masking(x: torch.Tensor, len_keep: int, noise: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep the ``len_keep`` tokens with the smallest noise, in noise order.

    x [N, L, D], noise [N, L]. Returns (x_masked [N, len_keep, D],
    mask [N, L] float32 with 1 = removed, ids_restore [N, L])."""
    ids_shuffle = _argsort(noise)
    x_masked = take_tokens(x, ids_shuffle[:, :len_keep])
    ids_restore, mask = _mask_from_shuffle(ids_shuffle, len_keep)
    return x_masked, mask, ids_restore


def _boost_set(r: torch.Tensor, count: int) -> torch.Tensor:
    """Per-sample subset of ``count`` of the r.shape[1] slots, as a bool mask:
    the ``count`` slots with the smallest uniforms."""
    return _argsort(_argsort(r)) < count


def structured_noise(base: torch.Tensor, r_t: torch.Tensor, r_f: torch.Tensor,
                     mask_ratio: float) -> torch.Tensor:
    """Structured 'tf' noise over the (f, t) patch grid.

    base [N, f, t] uniform noise; r_t [N, t] and r_f [N, f] uniforms that
    choose ``int(t*ratio*0.7)`` time columns and ``int(f*ratio*0.7)``
    frequency rows. Tokens in a chosen row or column get noise 1.1, so the
    argsort drops them first. Returns [N, f*t]."""
    N, f, t = base.shape
    bt = _boost_set(r_t, int(t * mask_ratio * 0.7))[:, None, :]
    bf = _boost_set(r_f, int(f * mask_ratio * 0.7))[:, :, None]
    noise = torch.where(bt | bf, torch.full_like(base, 1.1), base)
    return noise.reshape(N, f * t)


def random_masking_structured(x: torch.Tensor, mask_ratio: float, t: int,
                              f: int, base: torch.Tensor, r_t: torch.Tensor,
                              r_f: torch.Tensor):
    """'tf'-structured masking with gather; x [N, f*t, D]."""
    N, L, _ = x.shape
    if L != f * t:
        raise ValueError(f"{L} tokens do not fill the {f}x{t} audio grid")
    noise = structured_noise(base, r_t, r_f, mask_ratio)
    return random_masking(x, len_keep_for(L, mask_ratio), noise)


def masked_mean(x: torch.Tensor, keep: torch.Tensor, dim: int = 1
                ) -> torch.Tensor:
    """Mean over kept tokens only; the keep count is summed in float32."""
    keep_f = keep.to(x.dtype)[..., None]
    total = torch.sum(x * keep_f, dim=dim)
    count = torch.clamp(torch.sum(keep.to(torch.float32)[..., None], dim=dim),
                        min=1.0)
    return (total.to(torch.float32) / count).to(x.dtype)
