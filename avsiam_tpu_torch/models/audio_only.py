"""The audio-only finetune model of the port.

Counterpart of ``avsiam_tpu/models/audio_only.py:CAVMAEFTAudio`` (the
reference's ``audio_mdl.py``), with the same module names, so that
``utils/weights.py:params_from_jax`` maps the JAX tree one to one:

- ``patch_embed_a`` over the fbank as a one-channel [B, 1, F, T] image;
- ``pos_embed_a``, initialised to the fixed 2D sin-cos table over the
  audio grid (``models/pos_embed.py``), and ``modality_a``, a learned
  modality embedding (normal, std 0.02), both added to the tokens; the
  tokens are not doubled;
- ``modality_specific_depth`` blocks with the shared norms (``blocks_a``),
  then ``depth - modality_specific_depth`` blocks with the 'a' norms
  (``blocks_u``), then ``norm_a``;
- ``mlp_head``, the finetune model's LayerNorm + dense head, over the
  tokens' mean.

``norm`` and every norm set of every block exist for checkpoint parity
(the JAX init creates them) though the forward uses only some of them.
With ``tr_pos`` false the position table takes no gradient (the JAX
``stop_gradient``): it stays a parameter, and its gradient is zero.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from avsiam_tpu_torch.configs import ViTConfig
from avsiam_tpu_torch.device import resolve_device
from avsiam_tpu_torch.models.cavmae_ft import MlpHead
from avsiam_tpu_torch.models.layers import (Dense, LayerNormFP32,
                                            ModalityBlock, PatchEmbed)
from avsiam_tpu_torch.models.pos_embed import get_2d_sincos_pos_embed
from avsiam_tpu_torch.ops.patchify import audio_to_image


class CAVMAEFTAudio(nn.Module):
    """Audio-only classifier over ``vit``'s trunk geometry: 11 audio blocks
    and 1 unified block at ViT-B by default. Parameters live on ``device``
    ('cuda' by default; a missing card raises) and are initialised from
    ``generator`` (a generator on that device seeded with 0 when None):
    lecun-normal dense kernels, zero biases, unit LayerNorm scales."""

    def __init__(self, vit: ViTConfig, label_dim: int,
                 modality_specific_depth: int = 11, tr_pos: bool = True,
                 dtype=torch.float32, attn_impl: str = "auto",
                 mlp_impl: str = "auto", device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        c = vit
        self.vit = c
        self.dtype = dtype
        self.tr_pos = tr_pos
        self.patch_embed_a = PatchEmbed(c.dim, c.patch_size, 1, dtype, dev)
        f, t = c.audio_grid
        self.pos_embed_a = nn.Parameter(
            get_2d_sincos_pos_embed(c.dim, f, t)[None].to(dev))
        self.modality_a = nn.Parameter(torch.zeros(1, 1, c.dim, device=dev))

        def blocks(n):
            return nn.ModuleList(
                ModalityBlock(c.dim, c.num_heads, c.mlp_ratio, c.qkv_bias,
                              c.block_ln_eps, dtype, attn_impl, c.gelu,
                              mlp_impl, dev) for _ in range(n))

        self.blocks_a = blocks(modality_specific_depth)
        self.blocks_u = blocks(c.depth - modality_specific_depth)
        self.norm_a = LayerNormFP32(c.dim, c.block_ln_eps, dtype, dev)
        self.norm = LayerNormFP32(c.dim, c.block_ln_eps, dtype, dev)
        self.mlp_head = MlpHead(c.dim, label_dim, dtype, dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, Dense):
                m.reset_parameters(generator)
        nn.init.normal_(self.modality_a, 0.0, 0.02, generator=generator)

    def encode(self, a):
        """fbank [B, T, F] -> normalised tokens [B, La, C]."""
        x = self.patch_embed_a(audio_to_image(a.to(self.dtype)))
        pos = self.pos_embed_a if self.tr_pos else self.pos_embed_a.detach()
        x = x + pos.to(self.dtype)
        x = x + self.modality_a.to(self.dtype)
        for blk in self.blocks_a:
            x = blk(x, None)
        for blk in self.blocks_u:
            x = blk(x, "a")
        return self.norm_a(x)

    def forward(self, a):
        """The token features (``encode``)."""
        return self.encode(a)

    def forward_pred(self, a, v=None, mode: str = "audioonly"):
        """Logits [B, label_dim] from the tokens' mean; ``v`` and ``mode``
        are unused, kept for the multimodal callers' signature."""
        return self.mlp_head(self.encode(a).mean(dim=1))

    def forward_feat(self, a, v=None, mode: str = "av"):
        return self.encode(a)
