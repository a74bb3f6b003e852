"""Random masking for MAE-style training, with the noise passed in.

Counterpart of ``avsiam_tpu/ops/masking.py``. Every function takes its random
numbers as tensors, so a caller can hand it draws from a ``torch.Generator``
or, in a test, the very draws JAX made.

Sorts are stable (``stable=True``), as ``jnp.argsort`` is: structured 'tf'
masking boosts more tokens to 1.1 than the ratio removes, so ties at 1.1
decide which boosted tokens stay, and an unstable sort would pick others.

The keep masks (``keep_mask``, ``padded_keep_masks``) are the 'padded'
contrastive form's: per-sample boolean [N, L] masks in place of gathers,
with per-sample keep counts. They are device ops with no host sync, so a
captured CUDA graph can hold them.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def random_masking(x: torch.Tensor, len_keep: int, noise: torch.Tensor,
                   pad_to: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep the ``len_keep`` tokens with the smallest noise, in noise order.

    x [N, L, D], noise [N, L]. Returns (x_masked [N, len_keep, D],
    mask [N, L] float32 with 1 = removed, ids_restore [N, L]). With
    ``pad_to`` > len_keep, x_masked is [N, pad_to, D]: its tail rows gather
    id L, which ``take_tokens`` clamps to the last token, as JAX's CPU
    gather does; a key mask and masked pooling keep them out downstream."""
    N, L, _ = x.shape
    ids_shuffle = _argsort(noise)
    ids_keep = ids_shuffle[:, :len_keep]
    if pad_to is not None and pad_to > len_keep:
        ids_keep = torch.cat([ids_keep, ids_keep.new_full(
            (N, pad_to - len_keep), L)], dim=1)
    x_masked = take_tokens(x, ids_keep)
    ids_restore, mask = _mask_from_shuffle(ids_shuffle, len_keep)
    return x_masked, mask, ids_restore


def keep_mask(noise: torch.Tensor, count) -> torch.Tensor:
    """[N, L] bool: True at the ``count`` tokens of smallest noise in each
    row (ranks by a double stable argsort), the set ``random_masking``
    keeps. ``count`` is an int or an [N] tensor of per-row counts."""
    if isinstance(count, torch.Tensor):
        count = count[:, None]
    return _argsort(_argsort(noise)) < count


def structured_noise(base: torch.Tensor, r_t: torch.Tensor, r_f: torch.Tensor,
                     mask_ratio: float) -> torch.Tensor:
    """Structured 'tf' noise over the (f, t) patch grid.

    base [N, f, t] uniform noise; r_t [N, t] and r_f [N, f] uniforms that
    choose ``int(t*ratio*0.7)`` time columns and ``int(f*ratio*0.7)``
    frequency rows. Tokens in a chosen row or column get noise 1.1, so the
    argsort drops them first. Returns [N, f*t]."""
    _, f, t = base.shape
    return _boosted_noise(base, r_t, r_f, int(t * mask_ratio * 0.7),
                          int(f * mask_ratio * 0.7))


def _boosted_noise(base, r_t, r_f, count_t, count_f) -> torch.Tensor:
    """``structured_noise`` with its boost counts given (ints or [N]
    tensors)."""
    N, f, t = base.shape
    bt = keep_mask(r_t, count_t)[:, None, :]
    bf = keep_mask(r_f, count_f)[:, :, None]
    noise = torch.where(bt | bf, torch.full_like(base, 1.1), base)
    return noise.reshape(N, f * t)


def random_masking_structured(x: torch.Tensor, mask_ratio: float, t: int,
                              f: int, base: torch.Tensor, r_t: torch.Tensor,
                              r_f: torch.Tensor, pad_to: Optional[int] = None):
    """'tf'-structured masking with gather; x [N, f*t, D]; ``pad_to`` as
    ``random_masking``'s."""
    N, L, _ = x.shape
    if L != f * t:
        raise ValueError(f"{L} tokens do not fill the {f}x{t} audio grid")
    noise = structured_noise(base, r_t, r_f, mask_ratio)
    return random_masking(x, len_keep_for(L, mask_ratio), noise, pad_to)


def _per_sample(chunk: torch.Tensor, values) -> torch.Tensor:
    """[N] int64: ``values[chunk[n]]`` for each sample, from Python ints
    (device ops only: a table copied from the host would be a copy a
    captured graph cannot hold)."""
    out = torch.zeros_like(chunk)
    for i, val in enumerate(values):
        out = out.masked_fill(chunk == i, val)
    return out


def padded_keep_masks(perm_a: torch.Tensor, perm_v: torch.Tensor,
                      chunk_size: int, ratios, f: int, t: int,
                      base: torch.Tensor, r_t: torch.Tensor,
                      r_f: torch.Tensor, noise_v: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 'padded' contrastive form's keep masks (``avsiam_tpu/models/
    cavmae.py:456-499``): keep_a [B, f*t] and keep_v [B, Lv] bool.

    Sample perm[p] belongs to chunk p // chunk_size (the chunks of the
    permuted batch, ``chunk_sizes``) and is masked at that chunk's ratio:
    audio by structured 'tf' noise whose boost counts ``int(t*r*0.7)`` and
    ``int(f*r*0.7)`` are per sample, video by unstructured noise, each
    keeping ``len_keep_for(L, r)`` tokens. base [B, f, t], r_t [B, t],
    r_f [B, f] and noise_v [B, Lv] are uniforms over the batch in input
    order."""
    B = perm_a.shape[0]
    pos_chunk = torch.arange(B, device=perm_a.device) // chunk_size

    def chunk_of(perm):
        return torch.zeros_like(perm).scatter_(0, perm, pos_chunk)

    chunk_a, chunk_v = chunk_of(perm_a), chunk_of(perm_v)
    noise_a = _boosted_noise(
        base, r_t, r_f,
        _per_sample(chunk_a, [int(t * r * 0.7) for r in ratios]),
        _per_sample(chunk_a, [int(f * r * 0.7) for r in ratios]))
    keep_a = keep_mask(noise_a, _per_sample(
        chunk_a, [len_keep_for(f * t, r) for r in ratios]))
    keep_v = keep_mask(noise_v, _per_sample(
        chunk_v, [len_keep_for(noise_v.shape[1], r) for r in ratios]))
    return keep_a, keep_v


def masked_mean(x: torch.Tensor, keep: torch.Tensor, dim: int = 1
                ) -> torch.Tensor:
    """Mean over kept tokens only; the keep count is summed in float32."""
    keep_f = keep.to(x.dtype)[..., None]
    total = torch.sum(x * keep_f, dim=dim)
    count = torch.clamp(torch.sum(keep.to(torch.float32)[..., None], dim=dim),
                        min=1.0)
    return (total.to(torch.float32) / count).to(x.dtype)
