"""Transformer layers of the port: dense layer, LayerNorm, MLP, attention,
modality-routed block, patch embedding and the shared siamese ViT trunk.

Counterpart of ``avsiam_tpu/models/layers.py``, with the same module names so
that parameter paths map one to one (``utils/weights.py``). Dtype policy, as
flax ``Dense(dtype=compute, param_dtype=float32)`` has it: parameters are
float32 masters, cast to the compute dtype where they are used; LayerNorm
statistics, GELU and losses run in float32.

Attention runs through ``ops.attention.attention_qkv`` in the block's
``attn_impl`` (kernels K1/K2, or K5/K6 for head widths K1 does not take, on
the GPU); ``LayerNormFP32`` under ``AVSIAM_LN=pallas`` through
``ops.layernorm.layer_norm_fp32`` (kernel K10 in its backward); with
``mlp_impl`` 'lnfres' ('auto' where the MLP kernels take the width,
``mlp_route``) the MLP sub-block runs through ``ops.mlp.fused_ln_mlp``
(kernel K3 on the GPU), and with 'fused', 'fbwd' or 'fres' the MLP through
``ops.mlp.fused_mlp`` (kernels K4, K7, K8, K9). ``ModalityBlock`` also
runs in the token-concat form (``call_tconcat``), with ``remat``
rematerialised in the backward, and with ``r > 0`` merging tokens after
its attention (ToMe, ``models/tome.py``).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from avsiam_tpu_torch.configs import ViTConfig
from avsiam_tpu_torch.models.tome import bipartite_soft_matching, merge_wavg
from avsiam_tpu_torch.ops.attention import ATTN_IMPLS, attention_qkv
from avsiam_tpu_torch.ops.gelu import gelu as gelu_op
from avsiam_tpu_torch.ops.layernorm import layer_norm, layer_norm_fp32
from avsiam_tpu_torch.ops.mlp import (FUSED_IMPLS, fused_ln_mlp, fused_mlp,
                                      kernel_takes)
from avsiam_tpu_torch.ops.patchify import audio_to_image, patchify
from avsiam_tpu_torch.parallel import dist as pdist
from avsiam_tpu_torch.parallel.tp import ColumnLinear, RowLinear

MLP_IMPLS = ("dense", "remat_g", "remat_all", "fused", "fbwd", "fres", "auto",
             "lnfres")


def mlp_route(impl: str, dim: int, hidden: int) -> str:
    """The form ``impl`` takes for an MLP of width ``dim`` and hidden width
    ``hidden``: 'auto' is 'lnfres' wherever D and H are multiples of 128
    (``ops.mlp.kernel_takes``, the JAX accelerator branch's condition,
    ``avsiam_tpu/models/layers.py:339-343``: ViT-B, -L and -H alike) and the
    unfused 'dense' elsewhere; every other impl is itself. An explicit
    kernel impl at a width the kernels do not take raises at the kernel call
    on the card."""
    if impl != "auto":
        return impl
    return "lnfres" if kernel_takes(dim, hidden) else "dense"


# flax's lecun_normal: a normal truncated at two standard deviations, scaled
# so that the truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def trunc_normal_(w: torch.Tensor, std: float, generator) -> torch.Tensor:
    """flax ``truncated_normal(stddev)``: std times a standard normal cut at
    +-2."""
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class Dense(nn.Module):
    """Linear layer with float32 parameters computed in ``dtype``;
    ``weight`` is [out, in] (nn.Linear's layout), lecun-normal, zero bias.
    ``parallel`` ('column' or 'row', set by ``shard_model_``): the weight
    is this rank's shard, and the layer runs ``parallel/tp.py``'s
    column- or row-parallel form over the model group."""

    def __init__(self, in_features: int, out_features: int, dtype, device,
                 bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.parallel: Optional[str] = None
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def reset_parameters(self, generator) -> None:
        lecun_normal_(self.weight.data, self.weight.shape[1], generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        if self.parallel is None:
            return nn.functional.linear(x.to(dt), self.weight.to(dt), b)
        fn = ColumnLinear if self.parallel == "column" else RowLinear
        return fn.apply(x.to(dt), self.weight.to(dt), b, pdist.model_group())


class LayerNormFP32(nn.Module):
    """LayerNorm with float32 statistics (flax's formula, ops/layernorm.py);
    output cast to ``dtype``. Parameters ``weight`` (ones), ``bias``.

    ``AVSIAM_LN=pallas`` takes the JAX module's custom-VJP branch
    (``avsiam_tpu/models/layers.py:91-94``): x passes in its own dtype, is
    saved so, and the backward is K10 on the card. Otherwise x is upcast and
    autograd differentiates the float32 ops. The JAX package reads the flag
    once, at import; the port reads it at each call, so that one process
    can run both forms."""

    def __init__(self, features: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        if os.environ.get("AVSIAM_LN", "xla") == "pallas":
            y = layer_norm_fp32(x, self.weight, self.bias, self.eps)
        else:
            y = layer_norm(x.to(torch.float32), self.weight, self.bias,
                           self.eps)
        return y.to(self.dtype)


class Mlp(nn.Module):
    """fc1 -> GELU (float32) -> fc2. ``impl`` (``avsiam_tpu/models/layers.py``
    ``Mlp``):

    * 'dense': plain ops; autograd saves the pre-GELU hidden and the
      activation;
    * 'remat_g': the same forward, saving only the activation: the backward
      recomputes fc1 (``torch.utils.checkpoint``);
    * 'remat_all': the same forward, saving neither: the backward
      recomputes fc1 and the GELU;
    * 'fused', 'fbwd', 'fres': ``ops.mlp.fused_mlp``;
    * 'auto': 'fres' on the card where the kernels take the width
      (``mlp_route``), as on the TPU; 'dense' elsewhere and on the CPU;
    * 'lnfres': 'fres' here (the LN fold happens one level up, in
      ``ModalityBlock._mlp_res``; this is the 'av' tail's MLP).

    ``tp`` (set by ``shard_model_``): fc1 and fc2 hold this rank's shards
    of the hidden width, and the fused forms sum fc2's partial products
    and fc1's partial dx over the model group (``group``).
    """

    def __init__(self, dim: int, hidden_dim: int, dtype, gelu: str, device,
                 impl: str = "dense"):
        super().__init__()
        if impl not in MLP_IMPLS:
            raise ValueError(f"mlp impl {impl!r} not in {MLP_IMPLS}")
        self.dtype = dtype
        self.gelu = gelu
        self.impl = impl
        self.tp = False
        self.fc1 = Dense(dim, hidden_dim, dtype, device)
        self.fc2 = Dense(hidden_dim, dim, dtype, device)

    @property
    def group(self):
        """The model group the fused forms reduce over, or None."""
        return pdist.model_group() if self.tp else None

    def _act(self, x):
        return gelu_op(self.fc1(x), self.gelu)

    def forward(self, x):
        impl = self.impl
        if impl == "auto" and x.device.type != "cuda":
            impl = "dense"
        impl = mlp_route(impl, self.fc1.weight.shape[1],
                         self.fc1.weight.shape[0])
        if impl == "lnfres":
            impl = "fres"
        if impl in FUSED_IMPLS:
            return fused_mlp(x.to(self.dtype), self.fc1.weight, self.fc1.bias,
                             self.fc2.weight, self.fc2.bias, gelu=self.gelu,
                             impl=impl, group=self.group)
        if impl == "remat_all":
            return checkpoint(lambda x: self.fc2(self._act(x)), x,
                              use_reentrant=False)
        if impl == "remat_g":
            return self.fc2(checkpoint(self._act, x, use_reentrant=False))
        return self.fc2(self._act(x))


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection; ``attn_impl``
    picks the attention path (``ops.attention.attention_route``). Under
    tensor parallelism ``num_heads`` are this rank's heads, of ``shards``
    times as many."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool, dtype,
                 device, attn_impl: str = "auto"):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        self.num_heads = num_heads
        self.shards = 1  # the model ranks its heads are split over
        self.attn_impl = attn_impl
        self.qkv = Dense(dim, 3 * dim, dtype, device, bias=qkv_bias)
        self.proj = Dense(dim, dim, dtype, device)

    def attend(self, qkv, key_valid: Optional[torch.Tensor] = None):
        """The attention core alone: the fused projection [B, N, 3C] ->
        [B, N, C], before ``proj``."""
        return attention_qkv(qkv, self.num_heads, key_valid, self.attn_impl,
                             shards=self.shards)

    def attend_rows(self, qkv, chunk_shapes):
        """The attention core over the [T, 3C] rows of chunks [B_i, N_i]
        (``chunk_shapes``, T = sum B_i N_i), each chunk attending within
        itself on a contiguous row view of ``qkv``: [T, C]. The
        token-concat and packed contrastive forms run it."""
        outs, off = [], 0
        for b, n in chunk_shapes:
            o = self.attend(qkv[off:off + b * n].view(b, n, -1))
            outs.append(o.reshape(b * n, -1))
            off += b * n
        return torch.cat(outs)

    def forward(self, x, key_valid: Optional[torch.Tensor] = None,
                tome: bool = False):
        """``proj`` of the attention of x; with ``tome`` also the ToMe
        matching metric (``tome_metric``)."""
        qkv = self.qkv(x)
        out = self.proj(self.attend(qkv, key_valid))
        return (out, self.tome_metric(qkv)) if tome else out

    @torch.no_grad()
    def tome_metric(self, qkv):
        """The keys' mean over the heads, [B, N, D], from the [B, N, 3C]
        projection (``avsiam_tpu/models/layers.py:235-244``), summed in
        float32 and cast to qkv's dtype. The merge plan it feeds is built
        from sorts and argmaxes, so no gradient reaches it. Under tensor
        parallelism this rank's heads are summed, the sums added over the
        model group and divided by every head, so that each rank of the
        group draws the same plan as the whole width's mean."""
        B, N, _ = qkv.shape
        H = self.num_heads
        k = qkv.reshape(B, N, 3, H, -1)[:, :, 1].float().sum(dim=2)
        if self.shards > 1:
            torch.distributed.all_reduce(k, group=pdist.model_group())
        return (k / (H * self.shards)).to(qkv.dtype)


class ModalityBlock(nn.Module):
    """Pre-LN ViT block with modality-routed norm sets and shared attention
    and MLP weights. ``modality``: None -> norm1/norm2, 'a' -> norm*_a,
    'v' -> norm*_v, 'av' -> a tuple (a, v) with per-modality norms and joint
    attention, returning (out[:, :num_a], the pre-MLP video tail).

    With ``remat`` a call under autograd keeps only its inputs and runs its
    forward again in the backward (``torch.utils.checkpoint``), as flax's
    ``nn.remat`` of the block class does: its kernels' forward launches
    twice. ``call_tconcat`` is not rematerialised, as in JAX, where
    ``nn.remat`` wraps ``__call__`` only."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 qkv_bias: bool, ln_eps: float, dtype, attn_impl: str,
                 gelu: str, mlp_impl: str, device, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.ln_eps = ln_eps
        self.gelu = gelu
        self.mlp_impl = mlp_impl
        self.remat = remat
        for name in ("norm1", "norm1_a", "norm1_v", "norm2", "norm2_a",
                     "norm2_v"):
            setattr(self, name, LayerNormFP32(dim, ln_eps, dtype, device))
        self.attn = Attention(dim, num_heads, qkv_bias, dtype, device,
                              attn_impl)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, gelu, device,
                       mlp_impl)

    def forward(self, x, modality: Optional[str] = None,
                key_valid: Optional[torch.Tensor] = None, r: int = 0):
        """The block on x; ``r > 0`` (single-modality routings) merges the
        r most similar tokens after the attention sub-block (ToMe,
        ``models/tome.py``) and returns (x, keep), ``keep`` [B, N] false at
        the merged-away slots (``avsiam_tpu/models/layers.py:306-318``)."""
        if self.remat and torch.is_grad_enabled():
            # no block draws random numbers: reading the generator's state
            # would be a host read inside a captured graph
            return checkpoint(self._forward, x, modality, key_valid, r,
                              use_reentrant=False, preserve_rng_state=False)
        return self._forward(x, modality, key_valid, r)

    def _norms(self, modality: Optional[str]):
        """(norm1, norm2) of a single-modality routing."""
        if modality is None:
            return self.norm1, self.norm2
        if modality == "a":
            return self.norm1_a, self.norm2_a
        if modality == "v":
            return self.norm1_v, self.norm2_v
        raise ValueError(f"unknown modality: {modality}")

    def _forward(self, x, modality, key_valid, r=0):
        if modality == "av":
            a, v = x
            num_a = a.shape[1]
            x = torch.cat([self.norm1_a(a), self.norm1_v(v)], dim=1)
            x = x + self.attn(x, key_valid)
            a2 = self.norm2_a(x[:, :num_a])
            v2 = self.norm2_v(x[:, num_a:])
            out = x + self.mlp(torch.cat([a2, v2], dim=1))
            return out[:, :num_a], x[:, num_a:]
        n1, n2 = self._norms(modality)
        if r > 0:
            attn_out, metric = self.attn(n1(x), key_valid, tome=True)
            assign, keep = bipartite_soft_matching(metric, r)
            x, _ = merge_wavg(assign, x + attn_out)
            return self._mlp_res(x, n2), keep
        x = x + self.attn(n1(x), key_valid)
        return self._mlp_res(x, n2)

    def call_tconcat(self, x, modality: Optional[str], chunk_shapes):
        """Token-concat form (``avsiam_tpu/models/layers.py:353-384``): x
        [T, C] is the row concatenation of chunks [B_i, N_i, C]
        (``chunk_shapes`` ((B_i, N_i), ...), T = sum B_i N_i). The norms,
        the qkv and proj GEMMs and the MLP sub-block run once over all rows;
        attention runs per chunk at its own length, on contiguous row views
        of the one qkv output."""
        n1, n2 = self._norms(modality)
        x = x + self.attn.proj(self.attn.attend_rows(self.attn.qkv(n1(x)),
                                                     chunk_shapes))
        return self._mlp_res(x, n2)

    def _mlp_res(self, x, n2):
        """``x + mlp(n2(x))``, as one fused forward where ``mlp_route``
        gives 'lnfres' and x is at the block's dtype; a promoted x takes the
        unfused form, which keeps the residual in x's dtype
        (``avsiam_tpu/models/layers.py:344``)."""
        fc1 = self.mlp.fc1
        impl = mlp_route(self.mlp_impl, fc1.weight.shape[1],
                         fc1.weight.shape[0])
        if impl != "lnfres" or x.dtype != self.dtype:
            return x + self.mlp(n2(x))
        return fused_ln_mlp(x, n2.weight, n2.bias, fc1.weight, fc1.bias,
                            self.mlp.fc2.weight, self.mlp.fc2.bias,
                            eps=self.ln_eps, gelu=self.gelu,
                            group=self.mlp.group)


class PatchEmbed(nn.Module):
    """Patchify + linear projection (a stride-p convolution's equivalent)."""

    def __init__(self, dim: int, patch_size: int, in_chans: int, dtype,
                 device):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Dense(patch_size * patch_size * in_chans, dim, dtype,
                          device)

    def forward(self, x):  # x: [B, C, H, W]
        return self.proj(patchify(x, self.patch_size))


class SiameseViT(nn.Module):
    """The shared-weight audio/video ViT trunk: video and audio patch
    embeds, pos_embed [1, 1 + Lv, D] (the CLS row is kept for checkpoint
    parity but unused), pos_embed_a [1, La, D], modality-routed blocks and
    per-modality final norms. Embeddings are doubled before the blocks
    (``x = x + norm_pre(x)`` with an identity norm_pre). ``remat``
    rematerialises each block's calls (``ModalityBlock``), the JAX
    ``remat_blocks``."""

    def __init__(self, cfg: ViTConfig, dtype, attn_impl: str,
                 embed_double: bool, mlp_impl: str, device,
                 remat: bool = False):
        super().__init__()
        c = cfg
        self.dtype = dtype
        self.embed_double = embed_double
        self.patch_embed = PatchEmbed(c.dim, c.patch_size, 3, dtype, device)
        self.patch_embed_a = PatchEmbed(c.dim, c.patch_size, 1, dtype, device)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + c.num_video_tokens, c.dim, device=device))
        self.pos_embed_a = nn.Parameter(
            torch.zeros(1, c.num_audio_tokens, c.dim, device=device))
        self.blocks = nn.ModuleList(
            ModalityBlock(c.dim, c.num_heads, c.mlp_ratio, c.qkv_bias,
                          c.block_ln_eps, dtype, attn_impl, c.gelu, mlp_impl,
                          device, remat)
            for _ in range(c.depth))
        self.norm = LayerNormFP32(c.dim, c.final_ln_eps, dtype, device)
        self.norm_a = LayerNormFP32(c.dim, c.final_ln_eps, dtype, device)

    def reset_parameters(self, generator) -> None:
        trunc_normal_(self.pos_embed.data, 0.02, generator)
        trunc_normal_(self.pos_embed_a.data, 0.02, generator)

    def embed_audio(self, fbank):
        """[B, T, F] fbank -> [B, La, D] tokens."""
        a = self.patch_embed_a(audio_to_image(fbank.to(self.dtype)))
        a = a + self.pos_embed_a.to(self.dtype)
        return a + a if self.embed_double else a

    def embed_video(self, imgs):
        """[B, 3, H, W] -> [B, Lv, D] tokens (pos embed without its CLS row)."""
        v = self.patch_embed(imgs.to(self.dtype))
        v = v + self.pos_embed[:, 1:].to(self.dtype)
        return v + v if self.embed_double else v

    def run_blocks(self, x, modality: Optional[str] = None,
                   key_valid: Optional[torch.Tensor] = None):
        for blk in self.blocks:
            x = blk(x, modality, key_valid)
        return x

    def run_blocks_tconcat(self, x, modality: str, chunk_shapes):
        """Every block in token-concat form (``ModalityBlock.call_tconcat``)
        over the [T, C] rows of one modality's chunks."""
        for blk in self.blocks:
            x = blk.call_tconcat(x, modality, chunk_shapes)
        return x

    def final_norm(self, x, modality: str):
        return self.norm_a(x) if modality == "a" else self.norm(x)
