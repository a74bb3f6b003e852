"""GELU numerics: exact erf, the tanh approximation, and the three fast
erf-grade forms 'ans', 'cheb' and 'tanh5'.

Counterpart of ``avsiam_tpu/ops/gelu.py``, every form of ``GELU_IMPLS``:

- 'erf': exact;
- 'tanh': 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)));
- 'ans': erf by Abramowitz & Stegun 7.1.26 (one exp, one reciprocal, max
  |erf error| 1.5e-7);
- 'cheb': the Gaussian CDF as 0.5 + x r(x^2), r a degree-15 Chebyshev
  expansion evaluated by Clenshaw's recurrence (max |Phi error| 1.6e-7);
- 'tanh5': erf(z) ~ tanh(z q(z^2)) with a 5-term q (max |erf error|
  3.0e-6); its derivative is that of the approximation itself, on the
  clipped z.

The JAX Pallas MLP evaluates an 'erf' request as 'ans' and every other
form as asked (``avsiam_tpu/ops/mlp.py:_kernel_impl``), and so do the
port's fused MLP forms and their kernels K3, K4, K7 and K8
(``kernel_impl``; the form is a template parameter of the kernels'
epilogues, ``csrc/mlp_tile.cuh``). The backward kernels take GELU and
GELU' together (``gelu_act_grad_f32``), as the Pallas ``_bwd_fused_kernel``
does.
"""

from __future__ import annotations

import math

import torch

GELU_IMPLS = ("erf", "tanh", "ans", "cheb", "tanh5")
# the kernels' template code of each form (csrc/mlp_tile.cuh, GeluForm)
KERNEL_CODES = {"ans": 0, "tanh": 1, "cheb": 2, "tanh5": 3}

_INV_SQRT_2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_TANH_C = math.sqrt(2.0 / math.pi)

# Chebyshev Gaussian CDF (``avsiam_tpu/ops/gelu.py:81-101``): Phi(x) = 0.5 +
# x r(x^2), r expanded in T_k over x^2 in [0, XB^2]
_PHI_XB = 5.5241
_PHI_HI = _PHI_XB * _PHI_XB
_PHI_COEF = (
    1.7453262166e-01,
    -1.2245549191e-01,
    5.6471478729e-02,
    -2.6176051971e-02,
    1.1596678412e-02,
    -4.8265382104e-03,
    1.8749111940e-03,
    -6.7851131750e-04,
    2.2884733538e-04,
    -7.2054287449e-05,
    2.1223857706e-05,
    -5.8650471743e-06,
    1.5224583179e-06,
    -3.7438715481e-07,
    8.4960083070e-08,
    -2.0862519096e-08,
)

# tanh-composite erf (``avsiam_tpu/ops/gelu.py:151-160``): erf(z) ~
# tanh(z q(z^2)) on z clipped to [-ZC, ZC]
_T5_ZC = 4.0
_T5_COEF = (
    1.1283580408023280e+00,
    1.0293362111282685e-01,
    -4.9766147444393120e-04,
    -4.1481581200152707e-04,
    3.2207836663742104e-05,
)


def _check(impl: str):
    if impl not in GELU_IMPLS:
        raise ValueError(f"unknown gelu impl: {impl!r} (takes {GELU_IMPLS})")


def kernel_impl(gelu: str) -> str:
    """The form the fused MLP runs for a requested numerics: 'erf' has no
    kernel form and runs as 'ans'; every other form runs as asked."""
    _check(gelu)
    return "ans" if gelu == "erf" else gelu


def _ans_poly(t):
    return ((((1.061405429 * t - 1.453152027) * t + 1.421413741) * t
             - 0.284496736) * t + 0.254829592) * t


def erf_ans(x: torch.Tensor) -> torch.Tensor:
    a = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * a)
    return torch.sign(x) * (1.0 - _ans_poly(t) * torch.exp(-a * a))


def erfc_ans(w: torch.Tensor) -> torch.Tensor:
    """A&S 7.1.26 in its erfc form, poly(t) exp(-a^2), relative accuracy
    kept in the positive tail."""
    a = torch.abs(w)
    t = 1.0 / (1.0 + 0.3275911 * a)
    ec = _ans_poly(t) * torch.exp(-a * a)
    return torch.where(w >= 0, ec, 2.0 - ec)


def _phi_r(u):
    """Clenshaw evaluation of r(u^2) with Phi(u) = 0.5 + u r(u^2)."""
    s = u * u
    t = s * (2.0 / _PHI_HI) - 1.0
    t2 = 2.0 * t
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for c in _PHI_COEF[:0:-1]:
        b1, b2 = t2 * b1 - b2 + c, b1
    return t * b1 - b2 + _PHI_COEF[0]


def phi_cheb(x: torch.Tensor) -> torch.Tensor:
    """The Gaussian CDF by the Chebyshev expansion."""
    u = torch.clamp(x, -_PHI_XB, _PHI_XB)
    return 0.5 + u * _phi_r(u)


def erfc_cheb(w: torch.Tensor) -> torch.Tensor:
    """erfc(w) = 2 Phi(-sqrt(2) w) as 1 + 2 u r, flushed to 0 past the fit
    domain."""
    z = -1.4142135623730951 * w
    u = torch.clamp(z, -_PHI_XB, _PHI_XB)
    ec = 1.0 + 2.0 * (u * _phi_r(u))
    return torch.where(z < -_PHI_XB, torch.zeros_like(ec), ec)


def _t5_q(u):
    q = _T5_COEF[4]
    for c in _T5_COEF[3::-1]:
        q = q * u + c
    return q


def erf_tanh5(z: torch.Tensor) -> torch.Tensor:
    zc = torch.clamp(z, -_T5_ZC, _T5_ZC)
    return torch.tanh(zc * _t5_q(zc * zc))


def erfc_tanh5(w: torch.Tensor) -> torch.Tensor:
    return 1.0 + erf_tanh5(-w)


def gelu_f32(x: torch.Tensor, impl: str) -> torch.Tensor:
    """GELU of a float32 tensor."""
    _check(impl)
    if impl == "erf":
        return 0.5 * x * (1.0 + torch.erf(x * _INV_SQRT_2))
    if impl == "tanh":
        inner = _TANH_C * (x + 0.044715 * x * x * x)
        return 0.5 * x * (1.0 + torch.tanh(inner))
    if impl == "ans":
        return 0.5 * x * (1.0 + erf_ans(x * _INV_SQRT_2))
    if impl == "cheb":
        return x * phi_cheb(x)
    return 0.5 * x * (1.0 + erf_tanh5(x * _INV_SQRT_2))


def _tanh_act_grad(x):
    inner = _TANH_C * (x + 0.044715 * x * x * x)
    t = torch.tanh(inner)
    dinner = _TANH_C * (1.0 + 3 * 0.044715 * x * x)
    return (0.5 * x * (1.0 + t),
            0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * dinner)


def _tanh5_grad(x):
    """The derivative of the 'tanh5' approximation: with t = tanh(p(z)), p
    = z q(z^2), z = x / sqrt 2 clipped, gelu' = 0.5 (1 + t) + 0.5 x (1 -
    t^2) p'(z) / sqrt 2, p'(z) = q(u) + 2 u q'(u), u = z^2."""
    z = torch.clamp(x * _INV_SQRT_2, -_T5_ZC, _T5_ZC)
    u = z * z
    q = _t5_q(u)
    qp = 4.0 * _T5_COEF[4]
    for k in (3, 2, 1):
        qp = qp * u + k * _T5_COEF[k]
    t = torch.tanh(z * q)
    pprime = q + 2.0 * u * qp
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * pprime * _INV_SQRT_2


def gelu_grad_f32(x: torch.Tensor, impl: str) -> torch.Tensor:
    """d gelu / dx for float32 x: Phi(x) + x pdf(x), or the derivative of
    the 'tanh' and 'tanh5' approximations themselves."""
    _check(impl)
    if impl == "tanh":
        return _tanh_act_grad(x)[1]
    if impl == "tanh5":
        return _tanh5_grad(x)
    if impl == "cheb":
        cdf = phi_cheb(x)
    elif impl == "ans":
        cdf = 0.5 * (1.0 + erf_ans(x * _INV_SQRT_2))
    else:
        cdf = 0.5 * (1.0 + torch.erf(x * _INV_SQRT_2))
    pdf = torch.exp(-0.5 * x * x) * _INV_SQRT_2PI
    return cdf + x * pdf


def gelu_act_grad_f32(x: torch.Tensor, impl: str):
    """(gelu(x), gelu'(x)) for float32 x, sharing what the two have in
    common: for 'ans' one exp serves both, 'cheb' shares its CDF, 'tanh'
    its inner tanh."""
    _check(impl)
    if impl == "erf":
        cdf = 0.5 * (1.0 + torch.erf(x * _INV_SQRT_2))
        pdf = torch.exp(-0.5 * x * x) * _INV_SQRT_2PI
        return x * cdf, cdf + x * pdf
    if impl == "ans":
        z = x * _INV_SQRT_2
        a = torch.abs(z)
        t = 1.0 / (1.0 + 0.3275911 * a)
        eexp = torch.exp(-a * a)  # == exp(-x^2/2), shared with the pdf
        cdf = 0.5 * (1.0 + torch.sign(z) * (1.0 - _ans_poly(t) * eexp))
        pdf = eexp * _INV_SQRT_2PI
        return x * cdf, cdf + x * pdf
    if impl == "cheb":
        cdf = phi_cheb(x)
        pdf = torch.exp(-0.5 * x * x) * _INV_SQRT_2PI
        return x * cdf, cdf + x * pdf
    if impl == "tanh":
        return _tanh_act_grad(x)
    return gelu_f32(x, impl), _tanh5_grad(x)


def gelu(x: torch.Tensor, impl: str = "erf") -> torch.Tensor:
    """GELU with selectable numerics, in x's dtype, in the operation order
    of the JAX ``gelu`` (``jax.nn.gelu`` for 'erf' and 'tanh'): the
    multiplies in x's dtype with constants rounded to it; 'erf', 'ans',
    'cheb' and 'tanh5' take erfc of w = -x sqrt(1/2) in float32 and
    multiply 0.5 x erfc(w) in x's dtype; 'tanh' is x 0.5 (1 + tanh(c (x +
    0.044715 x^3)))."""
    _check(impl)
    dt = x.dtype

    def const(v):
        return torch.tensor(v, dtype=dt)

    if impl == "tanh":
        inner = const(_TANH_C) * (x + const(0.044715) * (x * x * x))
        return x * (0.5 * (1.0 + torch.tanh(inner)))
    w = (-x * const(0.7071067811865476)).to(torch.float32)
    erfc = {"erf": torch.erfc, "ans": erfc_ans, "cheb": erfc_cheb,
            "tanh5": erfc_tanh5}[impl]
    return 0.5 * x * erfc(w).to(dt)
