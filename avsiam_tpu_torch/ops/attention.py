"""Multi-head attention on the packed qkv projection [B, N, 3C] -> [B, N, C].

Counterpart of ``avsiam_tpu/ops/attention.py:attention_qkv`` on its Pallas
path: the token-major kernels ``_pallas_fwd_tm`` (K1) and ``_pallas_bwd_tm``
(K2). Here they are the CUDA kernels of ``csrc/attention.cu``; this module
holds their wrappers, their plain PyTorch version and the autograd Function
that joins them. The qkv channel order is (3, H, D), the layout of the fused
``qkv`` projection's output; ``key_valid`` [B, N] bool masks keys with a
-1e30 bias, as the JAX package's ``_bias_from_valid`` does.

On a CPU tensor ``attention_qkv`` runs the plain version (autograd gives its
backward); on a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from avsiam_tpu_torch import kernels

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (32, 64)


def attention_reference(xqkv: torch.Tensor, num_heads: int,
                        key_valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain version: softmax attention in float32 (from xqkv's values),
    output in xqkv's dtype."""
    B, N, C3 = xqkv.shape
    C = C3 // 3
    D = C // num_heads
    q, k, v = xqkv.to(torch.float32).reshape(B, N, 3, num_heads, D).unbind(2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    if key_valid is not None:
        bias = torch.zeros(key_valid.shape, dtype=torch.float32,
                           device=s.device).masked_fill(~key_valid, NEG_INF)
        s = s + bias[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return out.reshape(B, N, C).to(xqkv.dtype)


def _geometry(xqkv: torch.Tensor, num_heads: int,
              key_valid: Optional[torch.Tensor]):
    """Validate a kernel call; returns (B, N, H, D)."""
    if xqkv.device.type != "cuda":
        raise ValueError(f"attention kernel needs a CUDA tensor, got "
                         f"{xqkv.device}")
    if xqkv.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"attention kernel takes float32 or bfloat16, got "
                         f"{xqkv.dtype}")
    if xqkv.dim() != 3 or xqkv.shape[2] % (3 * num_heads) != 0:
        raise ValueError(f"xqkv must be [B, N, 3*H*D], got {tuple(xqkv.shape)}"
                         f" for {num_heads} heads")
    B, N, C3 = xqkv.shape
    D = C3 // (3 * num_heads)
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernel takes head dims {KERNEL_HEAD_DIMS}"
                         f", got {D}")
    if B == 0 or N == 0:
        raise ValueError("attention kernel needs a non-empty batch")
    if not xqkv.is_contiguous() or xqkv.data_ptr() % 16 != 0:
        raise ValueError("xqkv must be contiguous and 16-byte aligned")
    if key_valid is not None and (
            key_valid.shape != (B, N) or key_valid.dtype != torch.bool
            or key_valid.device != xqkv.device
            or not key_valid.is_contiguous()):
        raise ValueError("key_valid must be a contiguous [B, N] bool tensor "
                         "on the same device")
    return B, N, num_heads, D


def attention_fwd_kernel(xqkv: torch.Tensor, num_heads: int,
                         key_valid: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: returns (out [B, N, C] in xqkv's dtype, stats [B, H, N, 2] f32 =
    per-row softmax max and 1/denominator, the backward's input)."""
    B, N, H, D = _geometry(xqkv, num_heads, key_valid)
    lib = kernels.library()
    out = torch.empty((B, N, H * D), dtype=xqkv.dtype, device=xqkv.device)
    stats = torch.empty((B, H, N, 2), dtype=torch.float32, device=xqkv.device)
    err = lib.avsiam_attn_fwd(
        xqkv.data_ptr(), None if key_valid is None else key_valid.data_ptr(),
        out.data_ptr(), stats.data_ptr(), B, N, H, D,
        kernels.DTYPE_CODES[xqkv.dtype], D ** -0.5, kernels.stream_handle(xqkv))
    kernels.check(err, "attention forward")
    kernels.LAUNCHES["attention_fwd"] += 1
    return out, stats


def attention_bwd_kernel(xqkv: torch.Tensor, out: torch.Tensor,
                         stats: torch.Tensor, dout: torch.Tensor,
                         num_heads: int,
                         key_valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """K2: the [B, N, 3C] cotangent of ``attention_fwd_kernel``'s output."""
    B, N, H, D = _geometry(xqkv, num_heads, key_valid)
    for name, t, shape, dtype in (
            ("out", out, (B, N, H * D), xqkv.dtype),
            ("dout", dout, (B, N, H * D), xqkv.dtype),
            ("stats", stats, (B, H, N, 2), torch.float32)):
        if (t.shape != shape or t.dtype != dtype or t.device != xqkv.device
                or not t.is_contiguous() or t.data_ptr() % 16 != 0):
            raise ValueError(f"{name} must be a contiguous {shape} {dtype} "
                             f"tensor on {xqkv.device}")
    lib = kernels.library()
    delta = torch.empty((B, H, N), dtype=torch.float32, device=xqkv.device)
    dqkv = torch.empty_like(xqkv)
    err = lib.avsiam_attn_bwd(
        xqkv.data_ptr(), None if key_valid is None else key_valid.data_ptr(),
        out.data_ptr(), dout.data_ptr(), stats.data_ptr(), delta.data_ptr(),
        dqkv.data_ptr(), B, N, H, D, kernels.DTYPE_CODES[xqkv.dtype],
        D ** -0.5, kernels.stream_handle(xqkv))
    kernels.check(err, "attention backward")
    kernels.LAUNCHES["attention_bwd"] += 1
    return dqkv


class _AttentionKernel(torch.autograd.Function):
    """K1 forward, K2 backward."""

    @staticmethod
    def forward(ctx, xqkv, key_valid, num_heads):
        out, stats = attention_fwd_kernel(xqkv, num_heads, key_valid)
        ctx.save_for_backward(xqkv, out, stats, key_valid)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        xqkv, out, stats, key_valid = ctx.saved_tensors
        dqkv = attention_bwd_kernel(xqkv, out, stats, dout.contiguous(),
                                    ctx.num_heads, key_valid)
        return dqkv, None, None


def attention_qkv(xqkv: torch.Tensor, num_heads: int,
                  key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention on the packed qkv projection [B, N, 3C] -> [B, N, C]: the
    plain version for a CPU tensor, the kernels (K1, K2) otherwise."""
    if xqkv.device.type == "cpu":
        return attention_reference(xqkv, num_heads, key_valid)
    return _AttentionKernel.apply(xqkv, key_valid, num_heads)
