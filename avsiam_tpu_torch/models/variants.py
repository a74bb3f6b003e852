"""Model-family variants of the port.

Counterpart of ``avsiam_tpu/models/variants.py``: the reference's backbones
(CAV-MAE ViT-B, LARGE, HUGE, CLIP, DINO) differ only in encoder geometry and
init checkpoint, so they are ``ViTConfig`` presets plus a checkpoint tag;
'tiny' is the test preset at toy widths.
"""

from __future__ import annotations

from avsiam_tpu_torch.configs import (CAVMAEConfig, CAVMAEFTConfig,
                                      DecoderConfig, ViTConfig, replace)

VIT_PRESETS = {
    "tiny": ViTConfig(dim=32, depth=2, num_heads=2, patch_size=16,
                      img_size=32, audio_length=128, mel_bins=32),
    "base": ViTConfig(dim=768, depth=12, num_heads=12),
    "large": ViTConfig(dim=1024, depth=24, num_heads=16),
    "huge": ViTConfig(dim=1280, depth=32, num_heads=16, patch_size=16),
}

# timm checkpoint tags of each backbone (informational)
BACKBONE_CHECKPOINTS = {
    "cav-mae-base": "vit_base_patch16_224.augreg_in21k",
    "cav-mae-base-clip": "vit_base_patch16_clip_224.datacompxl",
    "cav-mae-base-dino": "vit_base_patch16_224.augreg2_in21k_ft_in1k",
    "cav-mae-large": "vit_large_patch16_224.augreg_in21k",
    "cav-mae-huge": "vit_huge_patch14_224",
}

_MODEL_TO_PRESET = {
    "cav-mae-base": "base",
    "cav-mae-base-clip": "base",
    "cav-mae-base-dino": "base",
    "cav-mae-large": "large",
    "cav-mae-huge": "huge",
    "cav-mae-tiny": "tiny",
    "tiny": "tiny",
    "base": "base",
    "large": "large",
    "huge": "huge",
}


def vit_config(model_name: str) -> ViTConfig:
    try:
        return VIT_PRESETS[_MODEL_TO_PRESET[model_name]]
    except KeyError:
        raise ValueError(
            f"unknown model '{model_name}'; options: "
            f"{sorted(_MODEL_TO_PRESET)}") from None


def decoder_config(model_name: str) -> DecoderConfig:
    if _MODEL_TO_PRESET[model_name] == "tiny":
        return DecoderConfig(dim=16, depth=1, num_heads=2)
    # the reference decoder is 512/8/16 for every backbone
    return DecoderConfig()


def pretrain_config(model_name: str, **overrides) -> CAVMAEConfig:
    return replace(CAVMAEConfig(vit=vit_config(model_name),
                                decoder=decoder_config(model_name)),
                   **overrides)


def finetune_config(model_name: str, label_dim: int, **overrides
                    ) -> CAVMAEFTConfig:
    return replace(CAVMAEFTConfig(vit=vit_config(model_name),
                                  label_dim=label_dim), **overrides)
