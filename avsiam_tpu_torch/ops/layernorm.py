"""LayerNorm with float32 statistics, in flax ``nn.LayerNorm``'s formula.

Counterpart of ``avsiam_tpu/ops/layernorm.py``. The variance is the clamped
mean of squares minus the squared mean, and the multiplier is folded as
``rstd * scale`` before it meets ``x - mu``: this is not
``torch.nn.functional.layer_norm``, whose variance is a two-pass mean of
squared deviations.

``layer_norm`` is the forward; under autograd its backward is autograd over
its ops. ``layer_norm_fp32`` is the custom-VJP form (``AVSIAM_LN=pallas``):
it saves x in its own dtype, and its backward is K10, the CUDA kernel of
``csrc/layernorm.cu`` that replaces the Pallas ``_ln_bwd_pallas``, on a CUDA
tensor whose C is a multiple of 128, and the analytic ``layer_norm_vjp``
everywhere else, as ``_ln_bwd_rule`` dispatches.
"""

from __future__ import annotations

import torch

from avsiam_tpu_torch import kernels

LN_BWD_MAX_C = 1280  # K10 keeps a row in registers: C/32 values a lane
LN_BWD_ROW_WARPS = 4  # warps a block of K10's rows kernel
LN_BWD_WARPS_PER_SM = 32
LN_BWD_SPLIT_ROWS = 16  # rows a block of K10's cols kernel takes at least
LN_BWD_MAX_SPLITS = 8


def _stats_f32(xf: torch.Tensor, eps: float):
    mu = xf.mean(dim=-1, keepdim=True)
    mu2 = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(mu2 - mu * mu, min=0.0)
    return mu, torch.rsqrt(var + eps)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in float32; output in x's dtype."""
    xf = x.to(torch.float32)
    mu, rstd = _stats_f32(xf, eps)
    mul = rstd * scale.to(torch.float32)
    y = (xf - mu) * mul + bias.to(torch.float32)
    return y.to(x.dtype)


def layer_norm_vjp(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                   eps: float):
    """Analytic VJP of ``layer_norm`` in float32: (dx in x's dtype, dscale,
    dbias), the sums running over every leading axis."""
    xf = x.to(torch.float32)
    dyf = dy.to(torch.float32)
    mu, rstd = _stats_f32(xf, eps)
    xhat = (xf - mu) * rstd
    lead = tuple(range(dyf.dim() - 1))
    dbias = dyf.sum(dim=lead)
    dscale = (dyf * xhat).sum(dim=lead)
    dxhat = dyf * scale.to(torch.float32)
    c1 = dxhat.mean(dim=-1, keepdim=True)
    c2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (dxhat - c1 - xhat * c2)
    return dx.to(x.dtype), dscale, dbias


# ------------------------------------------------------------------ K10
def ln_bwd_reference(x2, dy2, scale, eps: float):
    """Plain version of K10 on [R, C] rows: (dx in x2's dtype, dgamma [C],
    dbeta [C] in float32)."""
    return layer_norm_vjp(x2, scale, dy2, eps)


def ln_bwd_rows_per_warp(rows: int, num_sms: int) -> int:
    """Rows each warp of K10's rows kernel walks (blocks of
    ``LN_BWD_ROW_WARPS`` warps): 1 while every row fits on
    ``LN_BWD_WARPS_PER_SM`` warps an SM, half of the 64 an SM holds, so that
    all rows' loads are in flight at once; beyond that as many as spread the
    rows over that many warps, at most 4, each warp loading its next row
    while it reduces the current one."""
    return max(1, min(4, -(-rows // (num_sms * LN_BWD_WARPS_PER_SM))))


def ln_bwd_col_splits(rows: int) -> int:
    """Into how many row ranges K10's cols kernel splits the rows: a block
    per (range, 64-column stripe), the ranges of a stripe one thread-block
    cluster, whose first block adds the others' sums from their shared
    memory. As many as the largest portable cluster, ``LN_BWD_MAX_SPLITS``
    (measured the fastest at every phase-D shape, from 156 rows up), while
    each range keeps at least ``LN_BWD_SPLIT_ROWS`` rows."""
    return max(1, min(LN_BWD_MAX_SPLITS, rows // LN_BWD_SPLIT_ROWS))


def ln_bwd_kernel(x2, dy2, scale, eps: float):
    """K10 on [R, C] rows x2 and their cotangent dy2 (float32 or bfloat16,
    alike; C a multiple of 128 up to ``LN_BWD_MAX_C``), scale [C] float32:
    (dx in x2's dtype, dgamma [C], dbeta [C] in float32)."""
    if x2.device.type != "cuda":
        raise ValueError(f"LN backward kernel needs a CUDA tensor, got "
                         f"{x2.device}")
    if (x2.dim() != 2 or x2.dtype not in kernels.DTYPE_CODES
            or dy2.shape != x2.shape or dy2.dtype != x2.dtype
            or dy2.device != x2.device or not x2.is_contiguous()
            or not dy2.is_contiguous() or x2.shape[0] == 0
            or x2.shape[1] % 128 or x2.shape[1] > LN_BWD_MAX_C):
        raise ValueError(
            f"LN backward kernel takes contiguous [R, C] float32 or bfloat16 "
            f"x and dy alike, R > 0, C a multiple of 128 up to "
            f"{LN_BWD_MAX_C}; got {tuple(x2.shape)} {x2.dtype}, "
            f"{tuple(dy2.shape)} {dy2.dtype}")
    R, C = x2.shape
    f32 = torch.float32
    if (scale.shape != (C,) or scale.dtype != f32 or scale.device != x2.device
            or not scale.is_contiguous()):
        raise ValueError(f"scale must be a contiguous ({C},) float32 tensor "
                         f"on {x2.device}")
    if any(t.data_ptr() % 16 for t in (x2, dy2, scale)):
        raise ValueError("LN backward kernel reads 16-byte aligned rows")
    lib = kernels.library()
    rows_per_warp = ln_bwd_rows_per_warp(R, kernels.num_sms(x2.device))
    splits = ln_bwd_col_splits(R)
    dx = torch.empty_like(x2)
    dgamma = torch.empty((C,), dtype=f32, device=x2.device)
    dbeta = torch.empty((C,), dtype=f32, device=x2.device)
    stats = torch.empty((R, 2), dtype=f32, device=x2.device)
    err = lib.avsiam_ln_bwd(
        x2.data_ptr(), dy2.data_ptr(), scale.data_ptr(), dx.data_ptr(),
        dgamma.data_ptr(), dbeta.data_ptr(), stats.data_ptr(), R, C,
        rows_per_warp, splits, kernels.DTYPE_CODES[x2.dtype], eps,
        kernels.stream_handle(x2))
    kernels.check(err, "LN backward")
    kernels.LAUNCHES["ln_bwd"] += 1
    return dx, dgamma, dbeta


class _LayerNormFP32(torch.autograd.Function):
    """``layer_norm`` forward saving x in its own dtype; backward K10 or
    ``layer_norm_vjp`` (``_ln_bwd_rule``)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.bias_dtype = eps, bias.dtype
        return layer_norm(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        C = x.shape[-1]
        if x.device.type == "cuda" and C % 128 == 0:
            dx, dg, db = ln_bwd_kernel(
                x.reshape(-1, C).contiguous(),
                dy.to(x.dtype).reshape(-1, C).contiguous(),
                scale.to(torch.float32).contiguous(), ctx.eps)
            dx = dx.reshape(x.shape)
        else:
            dx, dg, db = layer_norm_vjp(x, scale, dy, ctx.eps)
        return dx, dg.to(scale.dtype), db.to(ctx.bias_dtype), None


def layer_norm_fp32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics, output in x's
    dtype; the backward runs K10 on the card (module docstring)."""
    return _LayerNormFP32.apply(x, scale, bias, float(eps))
