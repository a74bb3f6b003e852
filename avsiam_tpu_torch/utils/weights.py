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

``shard_state_dict`` cuts a full state_dict (parameters, or any dict of
the same names and shapes: gradients, Adam moments) to one model rank's
shards by ``parallel/mesh.py``'s rules, and ``gather_state_dict`` puts the
model ranks' shards back together, bit for bit. The fused qkv output is
[q | k | v], each H heads of D wide (``avsiam_tpu/models/layers.py:227-
232``): a rank's qkv shard is the q, k and v rows of its own H / model
heads, [q_r | k_r | v_r], the layout ``attention_qkv`` reads with H / model
heads, and not a contiguous third of the rows.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Iterator, Mapping, Sequence, Tuple

import numpy as np
import torch

from avsiam_tpu_torch.parallel.mesh import split_dim

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


def _qkv(name: str) -> bool:
    return ".attn.qkv." in f".{name}"


def shard_tensor(name: str, t: torch.Tensor, model_rank: int, model: int
                 ) -> torch.Tensor:
    """Model rank ``model_rank``'s shard of the parameter ``name`` (a
    contiguous copy; a replicated parameter as it is)."""
    dim = split_dim(name)
    if dim is None or model == 1:
        return t
    if t.shape[dim] % (3 * model if _qkv(name) else model):
        raise ValueError(f"{name} {tuple(t.shape)} does not split "
                         f"{model} ways along dim {dim}")
    if _qkv(name):  # q, k, v each cut to this rank's heads
        return torch.cat([part.chunk(model, dim)[model_rank]
                          for part in t.chunk(3, dim)], dim).contiguous()
    return t.chunk(model, dim)[model_rank].contiguous()


def gather_tensor(name: str, shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The parameter ``name`` whole from its shards in model rank order
    (``shard_tensor``'s inverse)."""
    dim = split_dim(name)
    if dim is None or len(shards) == 1:
        return shards[0]
    if _qkv(name):
        thirds = [s.chunk(3, dim) for s in shards]
        return torch.cat([torch.cat([t[i] for t in thirds], dim)
                          for i in range(3)], dim)
    return torch.cat(list(shards), dim)


def shard_state_dict(sd: Mapping[str, torch.Tensor], model_rank: int,
                     model: int) -> "OrderedDict[str, torch.Tensor]":
    """Model rank ``model_rank``'s part of the full state_dict ``sd`` over
    a model axis of ``model``: column-parallel weights (qkv, fc1) cut along
    their output rows and their biases with them, row-parallel weights
    (proj, fc2) along their input columns, every other entry whole."""
    return OrderedDict((k, shard_tensor(k, v, model_rank, model))
                       for k, v in sd.items())


def gather_state_dict(shards: Sequence[Mapping[str, torch.Tensor]]
                      ) -> "OrderedDict[str, torch.Tensor]":
    """The full state_dict from each model rank's (``shard_state_dict``'s
    results in model rank order), bit for bit; a replicated entry is model
    rank 0's."""
    return OrderedDict((k, gather_tensor(k, [s[k] for s in shards]))
                       for k in shards[0])
