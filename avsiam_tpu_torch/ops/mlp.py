"""The transformer block's MLP sub-block, ``x + fc2(gelu(fc1(LN(x))))``.

Counterpart of ``avsiam_tpu/ops/mlp.py:fused_ln_mlp`` (the 'lnfres' path):
the forward is the fused kernel ``_lnfwd_call`` (K3), here the CUDA kernel
of ``csrc/ln_mlp.cu``; the backward mirrors ``_lnfres_mlp_bwd`` in PyTorch
ops (it is plain XLA in the JAX package, so it has no kernel): recompute the
LN, take GELU' from the saved pre-GELU hidden, four products, the analytic
LN VJP, plus the residual's cotangent.

Numerics of both forwards: f32 LN statistics, GEMM operands in the
activation dtype with f32 accumulation, f32 GELU ('erf' evaluated as 'ans',
as the Pallas kernel does), the residual add in the activation dtype; the
pre-GELU hidden is saved in the activation dtype.

Weights use nn.Linear's layout: w1 [H, D] (fc1.weight), w2 [D, H]
(fc2.weight). On a CPU tensor the forward is the plain version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from avsiam_tpu_torch import kernels
from avsiam_tpu_torch.ops.gelu import gelu_act_grad_f32, gelu_f32, kernel_impl
from avsiam_tpu_torch.ops.layernorm import layer_norm, layer_norm_vjp

KERNEL_DIMS = (512, 768)
HIDDEN_CHUNK = 64  # hidden columns per step of the kernel's loop
ROW_TILE = 32      # rows per block
MAX_SPLITS = 16    # bounds the f32 partial sums at 16 x [T, D]


def hidden_splits(rows: int, hidden: int, num_sms: int) -> int:
    """Into how many ranges K3 splits the hidden dimension. One block (row
    tile, range) fits on an SM at a time and takes time in proportion to its
    chunks, so the call takes about waves * chunks per block; the smallest
    split count (the least f32 partial traffic) that minimises that."""
    tiles = -(-rows // ROW_TILE)
    chunks = hidden // HIDDEN_CHUNK

    def cost(s):
        return -(-tiles * s // num_sms) * -(-chunks // s)

    return min(range(1, min(chunks, MAX_SPLITS) + 1), key=cost)


def ln_mlp_reference(x2, ln_scale, ln_bias, w1, b1, w2, b2, eps: float,
                     gelu: str = "erf"):
    """Plain version on [T, D] rows: returns (out, pre-GELU hidden), both in
    x2's dtype; products in float32 from the given values."""
    dt = x2.dtype
    f32 = torch.float32
    n = layer_norm(x2, ln_scale, ln_bias, eps)
    hpre = n.to(f32) @ w1.to(f32).T + b1.to(f32)
    act = gelu_f32(hpre, kernel_impl(gelu)).to(dt)
    y = act.to(f32) @ w2.to(f32).T + b2.to(f32)
    return x2 + y.to(dt), hpre.to(dt)


def ln_mlp_fwd_kernel(x2, ln_scale, ln_bias, w1, b1, w2, b2, eps: float,
                      splits=None):
    """K3 on [T, D] rows of float32 or bfloat16: returns (out, pre-GELU
    hidden) in x2's dtype. Weights bf16, LN parameters and biases f32.
    ``splits`` (default ``hidden_splits``) sets into how many ranges the
    hidden dimension is cut across blocks."""
    if x2.device.type != "cuda":
        raise ValueError(f"LN-MLP kernel needs a CUDA tensor, got {x2.device}")
    if x2.dtype not in kernels.DTYPE_CODES or x2.dim() != 2:
        raise ValueError(f"x2 must be [T, D] float32 or bfloat16, got "
                         f"{tuple(x2.shape)} {x2.dtype}")
    T, D = x2.shape
    H = w1.shape[0]
    if D not in KERNEL_DIMS or H % HIDDEN_CHUNK != 0 or T == 0:
        raise ValueError(f"LN-MLP kernel takes D in {KERNEL_DIMS}, H a "
                         f"multiple of {HIDDEN_CHUNK} and T > 0; got T={T}, "
                         f"D={D}, H={H}")
    if not x2.is_contiguous():
        raise ValueError("x2 must be contiguous")
    for name, t, shape, dtype in (
            ("w1", w1, (H, D), torch.bfloat16), ("w2", w2, (D, H), torch.bfloat16),
            ("ln_scale", ln_scale, (D,), torch.float32),
            ("ln_bias", ln_bias, (D,), torch.float32),
            ("b1", b1, (H,), torch.float32), ("b2", b2, (D,), torch.float32)):
        if (t.shape != shape or t.dtype != dtype or t.device != x2.device
                or not t.is_contiguous() or t.data_ptr() % 32 != 0):
            raise ValueError(f"{name} must be a contiguous 32-byte-aligned "
                             f"{shape} {dtype} tensor on {x2.device}")
    lib = kernels.library()
    if splits is None:
        splits = hidden_splits(T, H, kernels.num_sms(x2.device))
    if not 1 <= splits <= H // HIDDEN_CHUNK:
        raise ValueError(f"splits must be in [1, {H // HIDDEN_CHUNK}], got "
                         f"{splits}")
    out = torch.empty_like(x2)
    hpre = torch.empty((T, H), dtype=x2.dtype, device=x2.device)
    partial = torch.empty((splits, -(-T // ROW_TILE) * ROW_TILE, D),
                          dtype=torch.float32, device=x2.device)
    err = lib.avsiam_ln_mlp_fwd(
        x2.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        hpre.data_ptr(), partial.data_ptr(), T, D, H, splits,
        kernels.DTYPE_CODES[x2.dtype], eps, kernels.stream_handle(x2))
    kernels.check(err, "LN-MLP forward")
    kernels.LAUNCHES["ln_mlp_fwd"] += 1
    return out, hpre


class _LnMlp(torch.autograd.Function):
    """Forward: K3 (CUDA) or its plain version (CPU). Backward: PyTorch ops
    mirroring ``_lnfres_mlp_bwd``."""

    @staticmethod
    def forward(ctx, x2, ln_scale, ln_bias, w1, b1, w2, b2, eps, gelu):
        if x2.device.type == "cpu":
            out, hpre = ln_mlp_reference(x2, ln_scale, ln_bias, w1, b1, w2,
                                         b2, eps, gelu)
        else:
            kernel_impl(gelu)  # the kernel evaluates GELU as 'ans'
            f32, bf16 = torch.float32, torch.bfloat16
            out, hpre = ln_mlp_fwd_kernel(
                x2, ln_scale.to(f32).contiguous(), ln_bias.to(f32).contiguous(),
                w1.to(bf16).contiguous(), b1.to(f32).contiguous(),
                w2.to(bf16).contiguous(), b2.to(f32).contiguous(), eps)
        ctx.save_for_backward(x2, ln_scale, ln_bias, w1, w2, hpre)
        ctx.eps, ctx.gelu, ctx.b1_dtype = eps, gelu, b1.dtype
        return out

    @staticmethod
    def backward(ctx, do):
        x2, g, bln, w1, w2, hpre = ctx.saved_tensors
        dt = x2.dtype
        f32 = torch.float32
        n = layer_norm(x2, g, bln, ctx.eps)  # recompute the LN output
        act, grad = gelu_act_grad_f32(hpre.to(f32), kernel_impl(ctx.gelu))
        gh = ((do @ w2).to(f32) * grad).to(dt)
        dn = (gh @ w1).to(dt)
        dw1 = gh.T @ n
        dw2 = do.T @ act.to(dt)
        db1 = gh.to(f32).sum(dim=0)
        db2 = do.to(f32).sum(dim=0)
        dx_ln, dgamma, dbeta = layer_norm_vjp(x2, g, dn, ctx.eps)
        dx = do + dx_ln  # the residual branch's cotangent joins here
        return (dx, dgamma.to(g.dtype), dbeta.to(bln.dtype), dw1.to(w1.dtype),
                db1.to(ctx.b1_dtype), dw2.to(w2.dtype), db2.to(ctx.b1_dtype),
                None, None)


def fused_ln_mlp(x: torch.Tensor, ln_scale, ln_bias, w1, b1, w2, b2,
                 eps: float = 1e-5, gelu: str = "erf") -> torch.Tensor:
    """``x + fc2(gelu(fc1(LN(x))))`` over x [..., D]. Parameters may be f32
    masters: the weights and biases are cast to x's dtype here (outside the
    autograd Function, so their gradients reach the masters in f32) and the
    LN parameters to f32."""
    shape = x.shape
    dt = x.dtype
    f32 = torch.float32
    out = _LnMlp.apply(x.reshape(-1, shape[-1]), ln_scale.to(f32),
                       ln_bias.to(f32), w1.to(dt), b1.to(dt), w2.to(dt),
                       b2.to(dt), float(eps), gelu)
    return out.reshape(shape)
