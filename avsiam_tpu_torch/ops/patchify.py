"""Patchify / unpatchify as reshapes, with (p_h, p_w, c) patch order.

Counterpart of ``avsiam_tpu/ops/patchify.py``: tokens are row-major over the
(H/p, W/p) grid and each patch flattens in (p_h, p_w, c) order, the
``einsum('nchpwq->nhwpqc')`` layout.
"""

from __future__ import annotations

import torch


def patchify(imgs: torch.Tensor, patch_size: int = 16) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/p)*(W/p), p*p*C]."""
    B, C, H, W = imgs.shape
    p = patch_size
    h, w = H // p, W // p
    x = imgs.reshape(B, C, h, p, w, p)
    x = x.permute(0, 2, 4, 3, 5, 1)  # nchpwq -> nhwpqc
    return x.reshape(B, h * w, p * p * C)


def unpatchify(x: torch.Tensor, channels: int, grid_h: int, grid_w: int,
               patch_size: int = 16) -> torch.Tensor:
    """[B, L, p*p*C] -> [B, C, H, W]."""
    B, L, _ = x.shape
    p = patch_size
    if L != grid_h * grid_w:
        raise ValueError(f"{L} tokens do not fill a {grid_h}x{grid_w} grid")
    x = x.reshape(B, grid_h, grid_w, p, p, channels)
    x = x.permute(0, 5, 1, 3, 2, 4)  # nhwpqc -> nchpwq
    return x.reshape(B, channels, grid_h * p, grid_w * p)


def audio_to_image(fbank: torch.Tensor) -> torch.Tensor:
    """[B, T, F] fbank -> [B, 1, F, T] one-channel image."""
    return fbank[:, None, :, :].transpose(2, 3)
