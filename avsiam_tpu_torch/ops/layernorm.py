"""LayerNorm with float32 statistics, in flax ``nn.LayerNorm``'s formula.

Counterpart of ``avsiam_tpu/ops/layernorm.py``. The variance is the clamped
mean of squares minus the squared mean, and the multiplier is folded as
``rstd * scale`` before it meets ``x - mu``: this is not
``torch.nn.functional.layer_norm``, whose variance is a two-pass mean of
squared deviations. The backward is autograd over these ops; the Pallas LN
backward of the JAX package (``_ln_bwd_pallas``) is off the pretrain path.
"""

from __future__ import annotations

import torch


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
