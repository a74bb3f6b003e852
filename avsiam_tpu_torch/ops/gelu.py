"""GELU numerics: exact erf, and the Abramowitz & Stegun 'ans' form.

Counterpart of ``avsiam_tpu/ops/gelu.py`` for the two forms the pretrain
path uses. 'erf' is exact; 'ans' evaluates erf with A&S 7.1.26 (one exp,
one reciprocal, max |erf error| 1.5e-7). The JAX Pallas MLP evaluates an
'erf' request as 'ans' (``avsiam_tpu/ops/mlp.py:_kernel_impl``), and so do the
port's fused MLP forms and their kernels K3, K4, K7 and K8 (``kernel_impl``).
The backward kernels take GELU and GELU' together in the shared-exp form of
``gelu_act_grad_f32``, as the Pallas ``_bwd_fused_kernel`` does.
"""

from __future__ import annotations

import math

import torch

GELU_IMPLS = ("erf", "ans")

_INV_SQRT_2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _check(impl: str):
    if impl not in GELU_IMPLS:
        raise ValueError(f"unknown gelu impl: {impl!r} (port has {GELU_IMPLS})")


def kernel_impl(gelu: str) -> str:
    """The form the fused MLP runs for a requested numerics: 'erf' -> 'ans'."""
    _check(gelu)
    return "ans"


def _ans_poly(t):
    return ((((1.061405429 * t - 1.453152027) * t + 1.421413741) * t
             - 0.284496736) * t + 0.254829592) * t


def erf_ans(x: torch.Tensor) -> torch.Tensor:
    a = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * a)
    return torch.sign(x) * (1.0 - _ans_poly(t) * torch.exp(-a * a))


def gelu_f32(x: torch.Tensor, impl: str) -> torch.Tensor:
    """GELU of a float32 tensor."""
    _check(impl)
    if impl == "erf":
        return 0.5 * x * (1.0 + torch.erf(x * _INV_SQRT_2))
    return 0.5 * x * (1.0 + erf_ans(x * _INV_SQRT_2))


def gelu_act_grad_f32(x: torch.Tensor, impl: str):
    """(gelu(x), gelu'(x)) for float32 x; for 'ans' one exp serves both."""
    _check(impl)
    if impl == "erf":
        cdf = 0.5 * (1.0 + torch.erf(x * _INV_SQRT_2))
        pdf = torch.exp(-0.5 * x * x) * _INV_SQRT_2PI
        return x * cdf, cdf + x * pdf
    z = x * _INV_SQRT_2
    a = torch.abs(z)
    t = 1.0 / (1.0 + 0.3275911 * a)
    eexp = torch.exp(-a * a)  # == exp(-x^2/2), shared with the pdf
    cdf = 0.5 * (1.0 + torch.sign(z) * (1.0 - _ans_poly(t) * eexp))
    pdf = eexp * _INV_SQRT_2PI
    return x * cdf, cdf + x * pdf


def gelu(x: torch.Tensor, impl: str = "erf") -> torch.Tensor:
    """GELU evaluated in float32, returned in x's dtype."""
    return gelu_f32(x.to(torch.float32), impl).to(x.dtype)
