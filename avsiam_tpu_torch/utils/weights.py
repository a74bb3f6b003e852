"""Carry parameters from the JAX package's tree to the port's state_dict.

``params_from_jax`` walks a nested dict of numpy arrays (a flax ``params``
tree, or any tree of the same shape: gradients, Adam moments) and returns
the port's ``state_dict``. It imports no flax: the tree is plain dicts.

Path mapping, flax -> port:
- ``blocks_3`` -> ``blocks.3``;
- ``norm1/ln/scale`` -> ``norm1.weight``, ``norm1/ln/bias`` -> ``norm1.bias``
  (the ``ln`` scope right above a LayerNorm's leaves is dropped, so a head's
  LayerNorm named ``ln``, ``mlp_head/ln/ln/scale``, is ``mlp_head.ln.weight``);
- Dense ``kernel`` [in, out] -> ``weight`` [out, in] (transposed);
- everything else keeps its name (``pos_embed``, ``mask_token``, ...).
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_BLOCK = re.compile(r"^blocks_(\d+)$")


def _walk(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, dict):
            yield from _walk(val, path)
        else:
            yield path, val


def port_name(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """(port parameter name, whether the array is transposed) of a flax
    path such as ('vit', 'blocks_3', 'attn', 'qkv', 'kernel')."""
    leaf = path[-1]
    scopes = path[:-1]
    if leaf in ("scale", "bias") and scopes and scopes[-1] == "ln":
        scopes = scopes[:-1]
    parts = []
    for p in scopes:
        m = _BLOCK.match(p)
        if m:
            parts += ["blocks", m.group(1)]
        else:
            parts.append(p)
    transpose = leaf == "kernel"
    parts.append({"kernel": "weight", "scale": "weight"}.get(leaf, leaf))
    return ".".join(parts), transpose


def params_from_jax(tree: Dict) -> "OrderedDict[str, torch.Tensor]":
    """Nested dict of arrays in the JAX package's layout -> the port's
    state_dict (float32 CPU tensors; ``load_state_dict`` moves them)."""
    out = OrderedDict()
    for path, val in _walk(tree):
        name, transpose = port_name(path)
        arr = np.asarray(val, dtype=np.float32)
        if transpose:
            arr = arr.T
        out[name] = torch.tensor(np.ascontiguousarray(arr))
    return out
