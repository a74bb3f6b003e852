"""A timm ViT checkpoint as the port's initial pretrain parameters.

Counterpart of ``avsiam_tpu/utils/torch_import.py``'s
``load_torch_checkpoint``, ``strip_module_prefix``, ``vit_surgery_from_timm``
and ``build_pretrain_from_timm``. The JAX package maps a timm state_dict onto
its flax tree; the port maps it straight onto its own ``state_dict``, in
the names ``utils/weights.py:params_from_jax`` gives the JAX tree, with the
reference's init-time weight surgery (cav_mae_base.py:236-303):

- the trunk's blocks take timm's blocks, their norms copied into the audio
  (``_a``) and video (``_v``) norm sets;
- the video patch embed is timm's conv as a linear layer over the patch's
  (row, column, channel) values, the audio one its mean over the three
  colour channels;
- the audio pos embed is timm's 196-token grid resampled to the audio
  tokens by nearest neighbour (torch ``F.interpolate``'s default:
  out[i] = in[floor(i * 196 / n)]);
- ``norm_a`` is a copy of ``norm``.

``build_pretrain_from_timm`` then sets both trunks (``vit`` and its copy
``ast``) and ``mm_layer_1/2`` (copies of the last block) over fresh
parameters, whose decoder it keeps. Tensors are float32 on the CPU;
``load_state_dict`` moves them.
"""

from __future__ import annotations

from typing import Dict

import torch

_NORMS = ("norm1", "norm2")


def strip_module_prefix(sd: Dict) -> Dict:
    """DataParallel 'module.' prefix removal (run_cavmae_ft_base.py:49-56)."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32).clone()


def _interp_tokens(pos: torch.Tensor, num_out: int) -> torch.Tensor:
    """[1, n, D] -> [1, num_out, D], nearest neighbour along the tokens."""
    idx = torch.arange(num_out) * pos.shape[1] // num_out
    return pos[:, idx].clone()


def vit_surgery_from_timm(sd: Dict, depth: int = 12,
                          num_audio_tokens: int = 512
                          ) -> Dict[str, torch.Tensor]:
    """Raw timm ViT state_dict -> the port's trunk state_dict (names
    without the ``vit.`` prefix), by the reference's surgery
    (cav_mae_base.py:264-303)."""
    sd = strip_module_prefix(sd)
    w = _f32(sd["patch_embed.proj.weight"])  # [D, 3, p, p]
    dim = w.shape[0]
    w = w.permute(0, 2, 3, 1)  # the (row, column, channel) patch layout
    bias = _f32(sd["patch_embed.proj.bias"])
    pos = _f32(sd["pos_embed"])  # [1, 1 + 196, D]
    out = {
        "pos_embed": pos,
        "pos_embed_a": _interp_tokens(pos[:, 1:], num_audio_tokens),
        "patch_embed.proj.weight": w.reshape(dim, -1).contiguous(),
        "patch_embed.proj.bias": bias,
        "patch_embed_a.proj.weight": w.mean(dim=-1).reshape(dim, -1)
        .contiguous(),
        "patch_embed_a.proj.bias": bias.clone(),
    }
    for i in range(depth):
        b = f"blocks.{i}"
        for n in _NORMS:
            for s in ("", "_a", "_v"):
                for leaf in ("weight", "bias"):
                    out[f"{b}.{n}{s}.{leaf}"] = _f32(sd[f"{b}.{n}.{leaf}"])
        for layer in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
            for leaf in ("weight", "bias"):
                key = f"{b}.{layer}.{leaf}"
                out[key] = _f32(sd[key])
    for norm in ("norm", "norm_a"):  # norm_a: a copy (cav_mae_base.py:299)
        for leaf in ("weight", "bias"):
            out[f"{norm}.{leaf}"] = _f32(sd[f"norm.{leaf}"])
    return out


def build_pretrain_from_timm(sd: Dict, fresh: Dict[str, torch.Tensor],
                             depth: int = 12, num_audio_tokens: int = 512
                             ) -> Dict[str, torch.Tensor]:
    """The pretrain model's state_dict from a timm ViT checkpoint, as the
    reference constructor builds it: ``vit`` the surgery's trunk, ``ast``
    a copy of it (cav_mae_base.py:303), ``mm_layer_1/2`` copies of its last
    block (:306-307); every other entry (the decoder) from ``fresh``."""
    trunk = vit_surgery_from_timm(sd, depth, num_audio_tokens)
    out = {k: v.detach().to("cpu", torch.float32).clone()
           for k, v in fresh.items()}
    for prefix in ("vit", "ast"):
        for k, v in trunk.items():
            out[f"{prefix}.{k}"] = v.clone()
    last = f"blocks.{depth - 1}."
    for name in ("mm_layer_1", "mm_layer_2"):
        for k, v in trunk.items():
            if k.startswith(last):
                out[f"{name}.{k[len(last):]}"] = v.clone()
    return out


def load_torch_checkpoint(path: str) -> Dict:
    return torch.load(path, map_location="cpu", weights_only=True)
