"""Tensor parallelism over the mesh's 'model' axis (Megatron-style).

Counterpart of the 'model' axis of ``avsiam_tpu/parallel/mesh.py``
(``_TP_RULES``, ``param_shardings``) and of ``avsiam_tpu/train/loops.py:
_shard_state``. JAX places the parameters and lets GSPMD derive the
collectives, gathering the operands of every Pallas kernel, which has no
partitioning rule; here each rank of a model group holds its shards and its
kernels run on them, and two collectives per sub-block give the unsharded
function up to the order of a float32 sum:

- a column-parallel input (the qkv and fc1 GEMMs' x): the identity forward,
  and in the backward the ranks' partial dx summed over the model group in
  float32, before its cast to x's dtype;
- a row-parallel output (proj and fc2): the ranks' partial products summed
  in float32, then the bias added once and the sum cast to the activation
  dtype, where the unsharded GEMM rounds its float32 accumulator once; the
  identity backward.

The fused MLP forms run the same two collectives inside their autograd
Functions (``ops/mlp.py``, ``group``). Both are exact across the group
(every rank receives the same sum), so a replicated parameter's gradient
and its update are the same bits on every rank of the group.

``shard_model_`` cuts a full model to this rank's shards in place, by the
rules of ``parallel/mesh.py``; ``full_state_dict`` and
``load_full_state_dict`` move state between the full form (checkpoints,
the probe, the JAX package's trees) and the shards, and
``full_optimizer_state`` / ``load_full_optimizer_state`` do the same for an
Adam's moments.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import torch
import torch.distributed as dist
import torch.nn.functional as F

from avsiam_tpu_torch.ops.mlp import mm_f32
from avsiam_tpu_torch.parallel import dist as pdist
from avsiam_tpu_torch.parallel.mesh import split_dim
from avsiam_tpu_torch.utils.weights import (gather_tensor, shard_state_dict,
                                            shard_tensor)


class ColumnLinear(torch.autograd.Function):
    """``F.linear(x, w, b)`` with w and b this rank's output rows; the
    backward sums dx over the model group in float32."""

    @staticmethod
    def forward(ctx, x, w, b, group):
        ctx.save_for_backward(x, w)
        ctx.group, ctx.has_bias = group, b is not None
        return F.linear(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        dy2 = dy.reshape(-1, dy.shape[-1])
        x2 = x.reshape(-1, x.shape[-1])
        dx = None
        if need_x:
            dx = mm_f32(dy2, w)
            dist.all_reduce(dx, group=ctx.group)
            dx = dx.to(x.dtype).view_as(x)
        dw = dy2.T @ x2 if need_w else None
        db = dy2.sum(dim=0) if ctx.has_bias and need_b else None
        return dx, dw, db, None


class RowLinear(torch.autograd.Function):
    """``F.linear(x, w, b)`` with x and w this rank's input columns: the
    float32 partial products summed over the model group, then b (whole)
    added once, then the cast to x's dtype; the identity backward."""

    @staticmethod
    def forward(ctx, x, w, b, group):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        x2 = x.reshape(-1, x.shape[-1])
        y = mm_f32(x2, w.T)
        dist.all_reduce(y, group=group)
        if b is not None:
            y = y + b.to(torch.float32)
        return y.to(x.dtype).view(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        dy2 = dy.reshape(-1, dy.shape[-1])
        x2 = x.reshape(-1, x.shape[-1])
        dx = (dy2 @ w).view_as(x) if need_x else None
        dw = dy2.T @ x2 if need_w else None
        db = dy2.sum(dim=0) if ctx.has_bias and need_b else None
        return dx, dw, db, None


def shard_of(model: torch.nn.Module):
    """(model rank, model size) of the shards ``model`` holds ((0, 1):
    whole)."""
    return getattr(model, "tp_shard", (0, 1))


def shard_model_(model: torch.nn.Module) -> torch.nn.Module:
    """Cut the full ``model`` to this rank's shards over the mesh's model
    axis, in place (nothing without one): each sharded parameter keeps its
    object (an optimizer made after this sees the shard), each ``Dense``
    takes its role from the rules ('column' for qkv and fc1, 'row' for
    proj and fc2), each ``Attention`` its local heads and each ``Mlp`` the
    model group for its fused forms."""
    from avsiam_tpu_torch.models.layers import Attention, Dense, Mlp
    r, m = pdist.model_rank(), pdist.model_size()
    if shard_of(model) != (0, 1):
        raise ValueError(f"the model already holds shards {shard_of(model)}")
    if m == 1:
        return model
    for name, mod in model.named_modules():
        if isinstance(mod, Dense):
            dim = split_dim(f"{name}.weight")
            mod.parallel = {None: None, 0: "column", 1: "row"}[dim]
        elif isinstance(mod, Attention):
            if mod.num_heads % m:
                raise ValueError(f"{name}: {mod.num_heads} heads do not "
                                 f"split {m} ways")
            mod.num_heads //= m
            mod.shards = m
        if isinstance(mod, Mlp):
            mod.tp = True
    with torch.no_grad():
        for name, p in model.named_parameters():
            if split_dim(name) is not None:
                p.data = shard_tensor(name, p.data, r, m)
    model.tp_shard = (r, m)
    return model


def _gather_over_model(name: str, t: torch.Tensor) -> torch.Tensor:
    """The whole of the sharded tensor ``name`` from every rank's shard."""
    group = pdist.model_group()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return gather_tensor(name, parts)


def full_state_dict(model: torch.nn.Module) -> "OrderedDict[str, torch.Tensor]":
    """The model's state_dict in the full, unsharded form: each shard
    gathered to the whole, a collective over the model group where the
    model holds shards, which every rank of it must call."""
    sd = model.state_dict()
    if shard_of(model)[1] == 1:
        return sd
    return OrderedDict(
        (k, _gather_over_model(k, v) if split_dim(k) is not None else v)
        for k, v in sd.items())


def load_full_state_dict(model: torch.nn.Module,
                         sd: Mapping[str, torch.Tensor], strict: bool = True):
    """Load a full state_dict into ``model``, cut to its shards first."""
    r, m = shard_of(model)
    return model.load_state_dict(shard_state_dict(sd, r, m), strict=strict)


def param_names(opt: torch.optim.Optimizer, model: torch.nn.Module):
    """The model's parameter names in the order of ``opt.state_dict()``'s
    indices."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in opt.param_groups for p in g["params"]]


_MOMENTS = ("exp_avg", "exp_avg_sq")


def full_optimizer_state(opt: torch.optim.Optimizer,
                         model: torch.nn.Module) -> Dict:
    """``opt.state_dict()`` with the moments of each sharded parameter
    gathered to the whole (collective under tensor parallelism); step
    counts and hyperparameters as they are."""
    sd = opt.state_dict()
    if shard_of(model)[1] == 1:
        return sd
    names = param_names(opt, model)
    state = {}
    for i, st in sorted(sd["state"].items()):
        state[i] = {k: (_gather_over_model(names[i], v)
                        if k in _MOMENTS and split_dim(names[i]) is not None
                        else v) for k, v in st.items()}
    return {**sd, "state": state}


def load_full_optimizer_state(opt: torch.optim.Optimizer,
                              model: torch.nn.Module, sd: Mapping) -> None:
    """Load a full optimizer state_dict into ``opt``, each moment cut to
    its parameter's shard first."""
    r, m = shard_of(model)
    if m > 1:
        names = param_names(opt, model)
        sd = {**sd, "state": {
            i: {k: (shard_tensor(names[i], v, r, m) if k in _MOMENTS else v)
                for k, v in st.items()}
            for i, st in sd["state"].items()}}
    opt.load_state_dict(sd)
