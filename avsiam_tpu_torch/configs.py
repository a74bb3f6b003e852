"""Configuration dataclasses of the port.

Field names and defaults are those of ``avsiam_tpu/configs.py`` (ViTConfig,
DecoderConfig, CAVMAEConfig, CAVMAEFTConfig, AudioConfig, OptimizerConfig,
MeshConfig, PretrainConfig, FinetuneConfig), with torch dtypes in place of
jnp ones. The port keeps its
own copy so that it imports nothing of the JAX package.

The port takes every value the JAX package takes (``ViTConfig.gelu``:
'erf', 'tanh', 'ans', 'cheb' or 'tanh5', the MLP kernels running 'erf' as
'ans'). ``CAVMAEConfig.mmixed_impl`` names the contrastive encoder's form: 'exact',
'tconcat', 'bucketed', 'packed' or 'padded' (the default, as in JAX);
``remat_blocks`` rematerialises the trunks' blocks in the backward
(``torch.utils.checkpoint``). ``attn_impl`` takes the JAX package's set:
'auto' (the token-major kernels K1/K2 where the shape allows, else the XLA
form in torch ops), 'pallas' (K1/K2, else the head-major kernels K5/K6, as
ViT-H's D=80 needs) and 'xla'. ``mlp_impl`` (encoder and ``mm_layer_1/2``)
and ``dec_mlp_impl`` (decoder; None means ``mlp_impl``) take the JAX
package's whole set: 'auto'/'lnfres' (the fused LN->MLP kernel K3), 'fused',
'fbwd', 'fres' (the MLP kernels K4, K7, K8, K9; at every width that is a
multiple of 128), 'dense', 'remat_g' and 'remat_all'. The environment
flag ``AVSIAM_LN=pallas``, read at each call, routes ``LayerNormFP32``'s
backward to K10. The presets of ``models/variants.py`` (ViT-B, -L, -H)
fill ``vit``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Tuple

import torch


@dataclass(frozen=True)
class ViTConfig:
    """Shared siamese ViT encoder geometry; defaults are ViT-B/16."""

    dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    patch_size: int = 16
    img_size: int = 224
    audio_length: int = 1024  # fbank frames (10 s @ 10 ms shift)
    mel_bins: int = 128
    block_ln_eps: float = 1e-5
    final_ln_eps: float = 1e-6
    qkv_bias: bool = True
    gelu: str = "erf"

    @property
    def video_grid(self) -> Tuple[int, int]:
        g = self.img_size // self.patch_size
        return (g, g)

    @property
    def audio_grid(self) -> Tuple[int, int]:
        # fbank [T, F] is a 1-channel image [F, T]: grid (F/p, T/p)
        return (self.mel_bins // self.patch_size,
                self.audio_length // self.patch_size)

    @property
    def num_video_tokens(self) -> int:
        gh, gw = self.video_grid
        return gh * gw

    @property
    def num_audio_tokens(self) -> int:
        gh, gw = self.audio_grid
        return gh * gw


@dataclass(frozen=True)
class DecoderConfig:
    """MAE decoder geometry."""

    dim: int = 512
    depth: int = 8
    num_heads: int = 16
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-5


@dataclass(frozen=True)
class CAVMAEConfig:
    """Pretraining model config."""

    vit: ViTConfig = field(default_factory=ViTConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    embed_double: bool = True
    contrast_temp: float = 0.05
    mae_mask_ratio: float = 0.75
    mmixed_num_chunks: int = 5
    mmixed_ratio_step: float = 0.2
    mmixed_impl: str = "padded"
    dtype: Any = torch.float32  # compute dtype; parameters stay float32
    attn_impl: str = "auto"
    mlp_impl: str = "auto"
    dec_mlp_impl: Any = None
    remat_blocks: bool = False


@dataclass(frozen=True)
class CAVMAEFTConfig:
    """Finetune model config (``models/cavmae_ft.py``); the eval forward
    runs ``num_eval_frames`` frames a clip."""

    vit: ViTConfig = field(default_factory=ViTConfig)
    label_dim: int = 527
    embed_double: bool = True
    num_eval_frames: int = 10
    dtype: Any = torch.float32
    attn_impl: str = "auto"
    mlp_impl: str = "auto"
    remat_blocks: bool = False


@dataclass(frozen=True)
class AudioConfig:
    """Audio front-end settings, read by the data layer's transforms
    (``data/dataset.py``: the fbank's geometry, SpecAugment's ``freqm`` and
    ``timem``, ``mixup``, ``noise``, the normalisation)."""

    num_mel_bins: int = 128
    target_length: int = 1024
    sample_rate: int = 16000
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    norm_mean: float = -5.081
    norm_std: float = 4.4849
    freqm: int = 0
    timem: int = 0
    mixup: float = 0.0
    noise: bool = False
    skip_norm: bool = False
    mean_pool_downsample: bool = False


@dataclass(frozen=True)
class OptimizerConfig:
    """torch.optim.Adam settings: betas (0.95, 0.999), L2 weight decay."""

    lr: float = 2e-4
    b1: float = 0.95
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 5e-7
    lrscheduler_start: int = 10
    lrscheduler_step: int = 5
    lrscheduler_decay: float = 0.5
    lr_adapt: bool = False
    lr_patience: int = 2


@dataclass(frozen=True)
class MeshConfig:
    """Device layout: ``data`` processes (-1: every one), ``model`` 1
    (``parallel/mesh.py:make_mesh``)."""

    data: int = -1
    model: int = 1


@dataclass(frozen=True)
class PretrainConfig:
    model: CAVMAEConfig = field(default_factory=CAVMAEConfig)
    audio: AudioConfig = field(default_factory=AudioConfig)
    opt: OptimizerConfig = field(default_factory=OptimizerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    batch_size: int = 64
    n_epochs: int = 25
    masking_ratio: float = 0.25
    masking_ratio_a: float = 0.25
    mask_mode: str = "unstructured"
    contrast_loss_weight: float = 1.0
    mae_loss_weight: float = 1.0
    n_print_steps: int = 100
    seed: int = 87
    exp_dir: str = "./exp/pretrain"
    save_model: bool = True
    keep_train_states: int = 1
    train_state_every: int = 1
    val_interval: int = 1


@dataclass(frozen=True)
class FinetuneConfig:
    """Finetune run settings. ``head_lr`` and ``mm_lr`` multiply the rate of
    the ``mlp_head*`` and ``mm_layer*`` parameter groups, ``freeze_base``
    gives the rest rate 0; ``ftmode`` is the training forward's mode and
    ``ftmode_test`` the eval's (None: ``ftmode``). With ``parity_optimizer`` (the
    default) and ``ftmode`` 'mm_grad' the step's Adam skips every parameter
    the routed loss does not reach, as torch's Adam does with gradients
    cleared to None and as the JAX package's gated Adam does; otherwise
    every parameter steps, the unreached ones on a zero gradient, as the
    JAX package's plain Adam does (``train/finetune.py``)."""

    model: CAVMAEFTConfig = field(default_factory=CAVMAEFTConfig)
    audio: AudioConfig = field(default_factory=AudioConfig)
    opt: OptimizerConfig = field(default_factory=OptimizerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    batch_size: int = 4
    n_epochs: int = 15
    head_lr: float = 100.0
    mm_lr: float = 100.0
    freeze_base: bool = False
    ftmode: str = "mm_grad"
    ftmode_test: Any = None
    parity_optimizer: bool = True
    loss: str = "BCE"  # 'BCE' | 'CE'
    metrics: str = "mAP"  # 'mAP' | 'acc'
    label_smooth: float = 0.1
    n_print_steps: int = 100
    seed: int = 87
    exp_dir: str = "./exp/ft"
    save_model: bool = True
    keep_train_states: int = 1
    train_state_every: int = 1


def replace(cfg, **kwargs):
    """dataclasses.replace passthrough so callers don't import dataclasses."""
    return dataclasses.replace(cfg, **kwargs)
