"""The device mesh: its data and model axes over the process group, and
the tensor-parallel placement of the parameters.

Counterpart of ``avsiam_tpu/parallel/mesh.py`` (``make_mesh``, ``_TP_RULES``,
``param_pspec``) and of the global-batch check of
``avsiam_tpu/train/loops.py:234-237``. The port's mesh is the process group,
one process a device, laid out as the JAX package's row-major ('data',
'model') device mesh (``parallel/dist.py:set_mesh``): a model group of
``model`` consecutive ranks holds one replica of the model, its attention
and MLP weights split Megatron-style by ``TP_RULES`` (``parallel/tp.py``);
the batch is split over the ``data`` replicas in contiguous blocks.

JAX keys its rules on flax paths (``attn/qkv/kernel``, [in, out]); the
port's table keys the same parameters on their names in the port
(``attn.qkv.weight``, nn.Linear's [out, in]), so a column-parallel weight
splits its dim 0 here where JAX splits dim 1. ``param_pspec`` gives each
name the JAX ``PartitionSpec``'s entries in the port's layout.
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional, Tuple

from avsiam_tpu_torch.configs import MeshConfig
from avsiam_tpu_torch.parallel import dist as pdist

MODEL_AXIS = "model"

# Megatron attention/MLP sharding: column-parallel qkv and fc1 (their
# outputs, dim 0 of nn.Linear's weight, and their biases), row-parallel
# proj and fc2 (their inputs, dim 1); proj's and fc2's biases stay whole
TP_RULES = (
    (re.compile(r"attn\.qkv\.weight$"), (MODEL_AXIS, None)),
    (re.compile(r"attn\.qkv\.bias$"), (MODEL_AXIS,)),
    (re.compile(r"attn\.proj\.weight$"), (None, MODEL_AXIS)),
    (re.compile(r"mlp\.fc1\.weight$"), (MODEL_AXIS, None)),
    (re.compile(r"mlp\.fc1\.bias$"), (MODEL_AXIS,)),
    (re.compile(r"mlp\.fc2\.weight$"), (None, MODEL_AXIS)),
)


def param_pspec(name: str) -> Tuple[Optional[str], ...]:
    """The placement of the parameter ``name`` in the port's layout: per
    dim, 'model' where it is split over the model axis, else None; () for
    a replicated parameter."""
    for pat, spec in TP_RULES:
        if pat.search(name):
            return spec
    return ()


def split_dim(name: str) -> Optional[int]:
    """The dim the parameter ``name`` is split along, or None."""
    spec = param_pspec(name)
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


class Mesh(NamedTuple):
    """The replicas along the data axis, and the ranks of one replica along
    the model axis."""

    data: int
    model: int = 1


def tp_refusal(model: int, model_cfg) -> Optional[str]:
    """Why a model axis of ``model`` cannot split the model of
    ``model_cfg`` (a ``CAVMAEConfig`` or ``CAVMAEFTConfig``), or None: it
    must divide the heads of every sharded attention and every MLP's
    hidden width, and leave the MLP kernels a shard width they take
    wherever they take the whole one (no route may fall back to the plain
    version on a shard)."""
    from avsiam_tpu_torch.ops.mlp import kernel_takes
    trunks = [("the ViT", model_cfg.vit.dim, model_cfg.vit.num_heads,
               model_cfg.vit.mlp_ratio)]
    dec = getattr(model_cfg, "decoder", None)
    if dec is not None:
        trunks.append(("the decoder", dec.dim, dec.num_heads, dec.mlp_ratio))
    for what, dim, heads, ratio in trunks:
        hidden = int(dim * ratio)
        if heads % model:
            return (f"--mesh_model {model} does not divide the {heads} "
                    f"attention heads of {what}")
        if hidden % model:
            return (f"--mesh_model {model} does not divide the MLP hidden "
                    f"width {hidden} of {what}")
        if kernel_takes(dim, hidden) and not kernel_takes(dim,
                                                          hidden // model):
            return (f"--mesh_model {model} leaves {what}'s MLP a shard of "
                    f"hidden width {hidden // model}, which the MLP kernels "
                    f"do not take (a multiple of 128)")
    return None


def make_mesh(cfg: MeshConfig = MeshConfig(), model_cfg=None) -> Mesh:
    """``cfg`` resolved against the world: ``model`` (at least 1) must
    divide it, ``data`` is -1 (world / model) or that; with ``model_cfg``
    the model axis must split that model (``tp_refusal``). Under a process
    group the ranks are split into the axes' subgroups
    (``dist.set_mesh``). Anything else raises SystemExit."""
    world = pdist.world_size()
    model = cfg.model
    if model < 1 or world % model:
        raise SystemExit(
            f"--mesh_model {model} does not divide the world of {world} "
            f"process(es): data x model must equal the world")
    data = world // model
    if cfg.data not in (-1, data):
        raise SystemExit(
            f"--mesh_data {cfg.data} x --mesh_model {model} does not match "
            f"the world of {world} process(es) (-1 takes world / model)")
    if model > 1 and model_cfg is not None:
        why = tp_refusal(model, model_cfg)
        if why:
            raise SystemExit(why)
    if pdist.active():
        pdist.set_mesh(model)
    return Mesh(data=data, model=model)


def local_batch(global_batch: int, data: int) -> int:
    """This replica's rows of a global batch over ``data`` replicas, which
    must divide it."""
    if global_batch % data:
        raise SystemExit(f"global batch {global_batch} not divisible by "
                         f"mesh data axis {data}")
    return global_batch // data
