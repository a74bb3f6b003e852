"""Per-pass touched parameter sets, by the port's parameter names.

Counterpart of ``avsiam_tpu/train/param_groups.py:touched_contrastive`` and
``touched_mae``, rewritten for ``named_parameters()`` names such as
``vit.blocks.3.norm1_a.weight``. Each pass's Adam updates only the
parameters its loss reaches (the reference's find_unused_parameters=True).
"""

from __future__ import annotations

import re

_BLOCK_SHARED_NORM = re.compile(r"blocks\.\d+\.norm[12]\.")
_BLOCK_MOD_NORM = re.compile(r"blocks\.\d+\.norm[12]_[av]\.")
_NORM_PLAIN = re.compile(r"(^|\.)norm[12]\.")
_NORM_V = re.compile(r"(^|\.)norm[12]_v\.")


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
