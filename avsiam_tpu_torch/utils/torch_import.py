"""Reference-format checkpoints as the port's parameters: a timm ViT as the
initial pretrain parameters, and a reference finetune (or pretrain) model's
state_dict as the finetune model's.

Counterpart of ``avsiam_tpu/utils/torch_import.py``'s
``load_torch_checkpoint``, ``strip_module_prefix``, ``vit_surgery_from_timm``,
``build_pretrain_from_timm``, ``mlp_head`` and ``import_cavmae_ft``. The JAX package maps a timm state_dict onto
its flax tree; the port maps it straight onto its own ``state_dict``, in
the names ``utils/weights.py:params_from_jax`` gives the JAX tree, with the
reference's init-time weight surgery (cav_mae_base.py:236-303):

- the trunk's blocks take timm's blocks, their norms copied into the audio
  (``_a``) and video (``_v``) norm sets;
- the video patch embed is timm's conv as a linear layer over the patch's
  (row, column, channel) values, the audio one its mean over the three
  colour channels;
- the audio pos embed is timm's 196-token grid resampled to the audio
  tokens by nearest neighbour (``models/pos_embed.py:
  interp_pos_embed_tokens``, torch ``F.interpolate``'s default: out[i] =
  in[floor(i * 196 / n)]);
- ``norm_a`` is a copy of ``norm``.

``build_pretrain_from_timm`` then sets both trunks (``vit`` and its copy
``ast``) and ``mm_layer_1/2`` (copies of the last block) over fresh
parameters, whose decoder it keeps. Tensors are float32 on the CPU;
``load_state_dict`` moves them.

``import_cavmae_ft`` merges a reference ``CAVMAEFT_BASE`` state_dict (its
trunk under ``vit_base.``, its heads ``nn.Sequential(LayerNorm, Linear)``
under ``mlp_head*.0``/``.1``) over a fresh finetune state_dict,
non-strictly as the reference loads it (run_cavmae_ft_base.py:243-258).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from avsiam_tpu_torch.models.pos_embed import interp_pos_embed_tokens

_NORMS = ("norm1", "norm2")


def strip_module_prefix(sd: Dict) -> Dict:
    """DataParallel 'module.' prefix removal (run_cavmae_ft_base.py:49-56)."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32).clone()


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
        "pos_embed_a": interp_pos_embed_tokens(pos[:, 1:], num_audio_tokens),
        "patch_embed.proj.weight": w.reshape(dim, -1).contiguous(),
        "patch_embed.proj.bias": bias,
        "patch_embed_a.proj.weight": w.mean(dim=-1).reshape(dim, -1)
        .contiguous(),
        "patch_embed_a.proj.bias": bias.clone(),
    }
    for i in range(depth):
        b = f"blocks.{i}"
        block = _reference_block(sd, b)
        for n in _NORMS:  # the norms copied into the _a and _v sets
            for s in ("_a", "_v"):
                for leaf in ("weight", "bias"):
                    block[f"{n}{s}.{leaf}"] = block[f"{n}.{leaf}"].clone()
        out.update({f"{b}.{k}": t for k, t in block.items()})
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


def _conv_as_dense(w) -> torch.Tensor:
    """A patch-embed conv weight [C, c, p, p] as the port's dense weight
    over the patch's (row, column, channel) values."""
    w = _f32(w)
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1).contiguous()


def _reference_trunk(sd: Dict, prefix: str, depth: int
                     ) -> Dict[str, torch.Tensor]:
    """A reference trunk's (``vit_base``) entries in the port's names
    (without the ``vit.`` prefix); a block keeps only the norm sets the
    checkpoint has."""
    p = prefix
    out = {"pos_embed": _f32(sd[f"{p}.pos_embed"]),
           "pos_embed_a": _f32(sd[f"{p}.pos_embed_a"])}
    for pe in ("patch_embed", "patch_embed_a"):
        out[f"{pe}.proj.weight"] = _conv_as_dense(sd[f"{p}.{pe}.proj.weight"])
        out[f"{pe}.proj.bias"] = _f32(sd[f"{p}.{pe}.proj.bias"])
    for n in ("norm", "norm_a"):
        for leaf in ("weight", "bias"):
            out[f"{n}.{leaf}"] = _f32(sd[f"{p}.{n}.{leaf}"])
    for i in range(depth):
        out.update({f"blocks.{i}.{k}": t
                    for k, t in _reference_block(sd, f"{p}.blocks.{i}").items()})
    return out


def _reference_block(sd: Dict, prefix: str) -> Dict[str, torch.Tensor]:
    out = {}
    for n in _NORMS:
        for s in ("", "_a", "_v"):
            if f"{prefix}.{n}{s}.weight" in sd:
                for leaf in ("weight", "bias"):
                    out[f"{n}{s}.{leaf}"] = _f32(sd[f"{prefix}.{n}{s}.{leaf}"])
    for layer in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
        out[f"{layer}.weight"] = _f32(sd[f"{prefix}.{layer}.weight"])
        if f"{prefix}.{layer}.bias" in sd:
            out[f"{layer}.bias"] = _f32(sd[f"{prefix}.{layer}.bias"])
    return out


def mlp_head(sd: Dict, prefix: str) -> Dict[str, torch.Tensor]:
    """A reference head, ``nn.Sequential(LayerNorm, Linear)`` ('.0' the
    LayerNorm, '.1' the Linear), in the port's names (``ln.*``,
    ``linear.*``, without the head's prefix)."""
    return {f"{mod}.{leaf}": _f32(sd[f"{prefix}.{i}.{leaf}"])
            for i, mod in ((0, "ln"), (1, "linear"))
            for leaf in ("weight", "bias")}


def import_cavmae_ft(sd: Dict, fresh: Dict[str, torch.Tensor],
                     depth: int = 12
                     ) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """A reference ``CAVMAEFT_BASE`` state_dict (or a pretrain one, whose
    heads it lacks; 'module.' prefixes stripped) merged over ``fresh``, the
    finetune model's state_dict: (state_dict, the names that kept their
    fresh values, the checkpoint's keys no part of the model takes).
    Shapes must agree."""
    sd = strip_module_prefix(sd)
    imported = {f"vit.{k}": t
                for k, t in _reference_trunk(sd, "vit_base", depth).items()}
    for name in ("mm_layer_1", "mm_layer_2"):
        if f"{name}.attn.qkv.weight" in sd:
            imported.update({f"{name}.{k}": t
                             for k, t in _reference_block(sd, name).items()})
    for name in ("mlp_head", "mlp_head_a", "mlp_head_mm", "mlp_head_mm_v2"):
        if f"{name}.0.weight" in sd:
            imported.update({f"{name}.{k}": t
                             for k, t in mlp_head(sd, name).items()})
    out = {k: v.detach().to("cpu", torch.float32).clone()
           for k, v in fresh.items()}
    for k, t in imported.items():
        if k in out:
            if out[k].shape != t.shape:
                raise ValueError(f"shape mismatch at {k}: {tuple(out[k].shape)}"
                                 f" vs {tuple(t.shape)}")
            out[k] = t
    missing = [k for k in out if k not in imported]
    unused = [k for k in sd
              if not k.startswith(("vit_base.", "mm_layer_", "mlp_head"))]
    return out, missing, unused


def load_torch_checkpoint(path: str) -> Dict:
    return torch.load(path, map_location="cpu", weights_only=True)
