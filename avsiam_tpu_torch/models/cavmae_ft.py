"""CAV-MAE finetuning and retrieval model of the port.

Counterpart of ``avsiam_tpu/models/cavmae_ft.py:CAVMAEFinetune`` (the
reference's ``CAVMAEFT_BASE``), with the same module names, so that
``utils/weights.py:params_from_jax`` maps the JAX tree one to one. The
forward takes ``mode`` in {'audioonly', 'videoonly', 'retrieval',
'mm_grad', 'joint_av'}:

- one shared ``SiameseViT`` trunk, audio through its 'a' norms and
  ``norm_a``, video frames (folded into the batch) through its 'v' norms
  and ``norm``;
- heads ``mlp_head`` (video), ``mlp_head_a`` (audio) and ``mlp_head_mm``
  (the fused 2C features), each a float32-statistics LayerNorm (eps 1e-5)
  and a dense layer; ``mlp_head_mm_v2`` (of C features) exists for
  checkpoint parity and is never called;
- ``mm_layer_1/2``, the fusion blocks, run with 'a' norms over the
  concatenated [audio, video] token stream; their mean-pooled halves are
  concatenated;
- the eval form of 'mm_grad' and 'joint_av' fuses every frame, each
  frame's video tokens beside the clip's audio tokens, with the frames
  folded into the batch of the fusion layers.

Every parameter the JAX model's init creates exists from construction:
all three norm sets of every block, both final norms, both patch embeds
and the unused head.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from avsiam_tpu_torch.configs import CAVMAEFTConfig
from avsiam_tpu_torch.device import resolve_device
from avsiam_tpu_torch.models.layers import (Dense, LayerNormFP32,
                                            ModalityBlock, SiameseViT)

MODES = ("audioonly", "videoonly", "retrieval", "mm_grad", "joint_av")


class MlpHead(nn.Module):
    """LayerNorm (float32 statistics, eps 1e-5, torch's default) then a
    dense layer to ``label_dim``: the reference's ``nn.Sequential(
    LayerNorm, Linear)``."""

    def __init__(self, dim: int, label_dim: int, dtype, device):
        super().__init__()
        self.ln = LayerNormFP32(dim, 1e-5, dtype, device)
        self.linear = Dense(dim, label_dim, dtype, device)

    def forward(self, x):
        return self.linear(self.ln(x))


class CAVMAEFinetune(nn.Module):
    """The finetune model. Parameters live on ``device`` ('cuda' by
    default; a missing card raises) and are initialised from ``generator``
    (a generator on that device seeded with 0 when None): lecun-normal
    dense kernels, zero biases, unit LayerNorm scales, truncated-normal
    (0.02) pos embeds."""

    def __init__(self, cfg: CAVMAEFTConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        c = cfg
        v = c.vit
        self.cfg = c
        self.vit = SiameseViT(v, c.dtype, c.attn_impl, c.embed_double,
                              c.mlp_impl, dev, c.remat_blocks)
        for name, dim in (("mlp_head", v.dim), ("mlp_head_a", v.dim),
                          ("mlp_head_mm", 2 * v.dim),
                          ("mlp_head_mm_v2", v.dim)):
            setattr(self, name, MlpHead(dim, c.label_dim, c.dtype, dev))
        for name in ("mm_layer_1", "mm_layer_2"):
            setattr(self, name, ModalityBlock(
                v.dim, v.num_heads, v.mlp_ratio, v.qkv_bias, v.block_ln_eps,
                c.dtype, c.attn_impl, v.gelu, c.mlp_impl, dev))
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, (Dense, SiameseViT)):
                m.reset_parameters(generator)

    # ------------------------------------------------------------ encoders
    def encode_audio(self, a):
        """fbank [B, T, F] -> normalised audio tokens [B, La, C]."""
        return self.vit.norm_a(self.vit.run_blocks(self.vit.embed_audio(a),
                                                   "a"))

    def encode_video_frames(self, v):
        """Frames [B, T, 3, H, W] -> normalised video tokens [B, T, Lv, C]
        (the frames folded into the batch)."""
        B, T = v.shape[:2]
        x = self.vit.embed_video(v.reshape(B * T, *v.shape[2:]))
        x = self.vit.norm(self.vit.run_blocks(x, "v"))
        return x.reshape(B, T, *x.shape[1:])

    def fuse(self, a_tokens, v_tokens):
        """[B, La, C] and [B, Lv, C] -> [B, 2C]: both streams concatenated
        through ``mm_layer_1/2`` with 'a' norms, each side mean-pooled."""
        La = a_tokens.shape[1]
        av = self.mm_layer_2(self.mm_layer_1(
            torch.cat([a_tokens, v_tokens], dim=1), "a"), "a")
        return torch.cat([av[:, :La].mean(dim=1), av[:, La:].mean(dim=1)],
                         dim=-1)

    # ------------------------------------------------------------- forward
    def forward(self, a, v, mode: str, is_eval: bool = False):
        """``a`` [B, T, F]; ``v`` [B, 1, 3, H, W] in training, [B, T, 3, H,
        W] (T frames) in eval. Returns, by mode:

        - 'audioonly': audio logits [B, C] ([B, 1, C] in eval);
        - 'videoonly': video logits per frame [B, T, C], [B, C] for T = 1;
        - 'retrieval': audio tokens [B, La, C] and frame 5's video tokens
          [B, Lv, C] (frame 0's when fewer than six frames are given);
        - 'mm_grad': training (fused, audio, video) logits, each [B, C];
          eval the fused logits of every frame [B, T, C];
        - 'joint_av': the fused logits alone ([B, C]; [B, T, C] in eval).
        """
        if mode == "audioonly":
            out = self.mlp_head_a(self.encode_audio(a).mean(dim=1))
            return out[:, None] if is_eval else out
        if mode == "videoonly":
            out = self.mlp_head(self.encode_video_frames(v).mean(dim=2))
            return out[:, 0] if out.shape[1] == 1 else out
        if mode == "retrieval":
            v_tok = self.encode_video_frames(v)
            return (self.encode_audio(a),
                    v_tok[:, 5 if v_tok.shape[1] > 5 else 0])
        if mode not in ("mm_grad", "joint_av"):
            raise ValueError(f"unknown mode: {mode}")
        a_tok = self.encode_audio(a)
        v_tok = self.encode_video_frames(v)
        if is_eval:
            B, T, Lv, C = v_tok.shape
            a_rep = a_tok[:, None].expand(B, T, *a_tok.shape[1:])
            fused = self.fuse(a_rep.reshape(B * T, -1, C),
                              v_tok.reshape(B * T, Lv, C))
            return self.mlp_head_mm(fused).reshape(B, T, -1)
        vt = v_tok[:, 0]
        out = self.mlp_head_mm(self.fuse(a_tok, vt))
        if mode == "joint_av":
            return out
        return (out, self.mlp_head_a(a_tok.mean(dim=1)),
                self.mlp_head(vt.mean(dim=1)))

    def forward_feat(self, a, v):
        """Per-modality encoded tokens ([B, La, C], [B, Lv, C]) of audio and
        one frame (``v`` [B, 3, H, W] or [B, 1, 3, H, W])."""
        if v.dim() == 4:
            v = v[:, None]
        return self.encode_audio(a), self.encode_video_frames(v)[:, 0]
