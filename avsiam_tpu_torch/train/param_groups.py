"""Per-pass touched parameter sets and the finetune learning-rate groups,
by the port's parameter names.

Counterpart of ``avsiam_tpu/train/param_groups.py`` (``touched_contrastive``,
``touched_mae``, ``ft_touched``, ``ft_group``, ``derive_touched_mask``),
rewritten for ``named_parameters()`` names such as
``vit.blocks.3.norm1_a.weight``. Each pass's Adam updates only the
parameters its loss reaches (the reference's find_unused_parameters=True).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

_BLOCK_SHARED_NORM = re.compile(r"blocks\.\d+\.norm[12]\.")
_BLOCK_MOD_NORM = re.compile(r"blocks\.\d+\.norm[12]_[av]\.")
_NORM_PLAIN = re.compile(r"(^|\.)norm[12]\.")
_NORM_V = re.compile(r"(^|\.)norm[12]_v\.")
_NORM_A = re.compile(r"(^|\.)norm[12]_a\.")


def touched_contrastive(name: str) -> bool:
    """Pass 1 (multi-ratio contrastive): only the vit trunk, with 'a'/'v'
    norm routing (its blocks' shared norms are unused)."""
    if not name.startswith("vit."):
        return False
    return not _BLOCK_SHARED_NORM.search(name)


def touched_mae(name: str) -> bool:
    """Pass 2 (MAE): vit embeds, video 'v' blocks and vit.norm; ast blocks
    with the shared norms and ast.norm_a; mm layers with 'a' norms; the
    whole decoder (its blocks use the shared norms)."""
    if name.startswith("vit."):
        if _BLOCK_SHARED_NORM.search(name) or _BLOCK_MOD_NORM.search(name):
            return bool(_NORM_V.search(name))  # only norm{1,2}_v on video
        return not name.startswith("vit.norm_a.")  # audio norm is ast's here
    if name.startswith("ast."):
        if "patch_embed" in name or "pos_embed" in name:
            return False  # embeddings always come from vit
        if _BLOCK_MOD_NORM.search(name):
            return False  # ast blocks run with modality None
        return not name.startswith("ast.norm.")  # ast's video norm unused
    if name.startswith("mm_layer_"):
        return not (_NORM_PLAIN.search(name) or _NORM_V.search(name))
    if name.startswith("decoder."):
        return not _BLOCK_MOD_NORM.search(name)
    return False


def ft_touched(name: str, branch: str) -> bool:
    """Whether the finetune 'mm_grad' loss of ``branch`` reaches a
    parameter (traintest_ft_base.py:149-157): 'av', the fused loss, both
    encoder routes, the fusion layers ('a' norms) and ``mlp_head_mm``; 'a'
    the audio route and ``mlp_head_a``; 'v' the video route and
    ``mlp_head``. ``mlp_head_mm_v2`` is in no loss."""
    if name.startswith("mlp_head_mm_v2."):
        return False
    if name.startswith("mlp_head_mm."):
        return branch == "av"
    if name.startswith("mlp_head_a."):
        return branch == "a"
    if name.startswith("mlp_head."):
        return branch == "v"
    if name.startswith("mm_layer"):
        return branch == "av" and not (_NORM_PLAIN.search(name)
                                       or _NORM_V.search(name))
    if name.startswith("vit."):
        audio = (name.startswith(("vit.patch_embed_a.", "vit.norm_a."))
                 or name == "vit.pos_embed_a" or bool(_NORM_A.search(name)))
        video = (name.startswith(("vit.patch_embed.", "vit.norm."))
                 or name == "vit.pos_embed" or bool(_NORM_V.search(name)))
        shared_norm = bool(_BLOCK_SHARED_NORM.search(name))
        shared = not (audio or video or shared_norm)
        if branch == "av":
            return not shared_norm
        if branch == "a":
            return audio or shared
        return video or shared
    return False


def ft_group(name: str) -> str:
    """The finetune learning-rate group (traintest_ft_base.py:50-83):
    'mlp' for the ``mlp_head*`` parameters, 'mm' for ``mm_layer*``, 'base'
    for the rest."""
    top = name.split(".", 1)[0]
    if top.startswith("mlp_head"):
        return "mlp"
    if top.startswith("mm_layer"):
        return "mm"
    return "base"


def derive_touched_mask(grads: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """Name -> whether the gradient has a nonzero element (a gradient of
    None counts as untouched)."""
    return {n: g is not None and bool((g != 0).any())
            for n, g in grads.items()}
