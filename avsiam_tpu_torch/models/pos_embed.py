"""Positional-embedding tables of the port.

Counterpart of ``avsiam_tpu/models/pos_embed.py``:

- ``get_2d_sincos_pos_embed``: MAE's fixed 2D sin-cos table over a
  rectangular grid, computed as the JAX package computes it (numpy,
  float64, one cast to float32 at the end), so that the two tables are the
  same bits;
- ``interp_pos_embed_tokens``: the nearest-neighbour resample along the
  token axis that the reference's ``F.interpolate(pos, size=n)`` default
  gives, out[i] = in[i * n_in // n_out];
- ``interpolate_pos_embed_2d``: the bicubic grid resize of a checkpoint's
  table to another input resolution, as ``jax.image.resize(...,
  'bicubic')`` gives it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _get_1d_sincos_pos_embed_from_grid(embed_dim: int,
                                       pos: np.ndarray) -> np.ndarray:
    if embed_dim % 2:
        raise ValueError(f"embed_dim {embed_dim} is odd")
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_h_size: int,
                            grid_w_size: int,
                            cls_token: bool = False) -> torch.Tensor:
    """The [gh * gw (+1), embed_dim] float32 sin-cos table: the grid built
    with meshgrid(w, h), w first, half the channels encoding h and half w;
    with ``cls_token`` a zero row first."""
    grid_h = np.arange(grid_h_size, dtype=np.float32)
    grid_w = np.arange(grid_w_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)
    grid = grid.reshape([2, 1, grid_h_size, grid_w_size])
    emb_h = _get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = _get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    table = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token:
        table = np.concatenate([np.zeros([1, embed_dim]), table], axis=0)
    return torch.from_numpy(table.astype(np.float32))


def interp_pos_embed_tokens(pos: torch.Tensor, num_out: int) -> torch.Tensor:
    """[1, n_in, D] -> [1, num_out, D], nearest neighbour along the tokens
    with integer indices (a new tensor)."""
    idx = torch.arange(num_out, device=pos.device) * pos.shape[1] // num_out
    return pos[:, idx]


def interpolate_pos_embed_2d(pos: torch.Tensor, new_grid: Tuple[int, int],
                             num_prefix_tokens: int = 1) -> torch.Tensor:
    """Bicubic resize of a [1, prefix + g*g, D] table's square grid to
    ``new_grid`` (gh, gw); the prefix rows pass unchanged.

    ``antialias=True`` is what makes this ``jax.image.resize``'s bicubic:
    Keys' cubic with a = -0.5, its kernel widened by the scale where the
    grid shrinks, and the weights renormalised where they run past an
    edge. Plain ``F.interpolate(mode='bicubic', align_corners=False)``
    samples the same positions but clamps at the edges and never widens
    the kernel, and lies 0.26 (14 -> 24) to 1.6 (14 -> 8) off on a
    unit-normal grid."""
    prefix = pos[:, :num_prefix_tokens]
    grid = pos[:, num_prefix_tokens:]
    old = int(round(float(np.sqrt(grid.shape[1]))))
    D = grid.shape[-1]
    grid = grid.reshape(1, old, old, D).permute(0, 3, 1, 2)
    resized = F.interpolate(grid, size=tuple(new_grid), mode="bicubic",
                            align_corners=False, antialias=True)
    resized = resized.permute(0, 2, 3, 1).reshape(
        1, new_grid[0] * new_grid[1], D)
    return torch.cat([prefix, resized], dim=1)
