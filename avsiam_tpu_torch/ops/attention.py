"""Multi-head attention on the packed qkv projection [B, N, 3C] -> [B, N, C],
and head-major attention on q, k, v [B, N, H, D].

Counterpart of ``avsiam_tpu/ops/attention.py``: ``attention_qkv`` with its
dispatch, ``xla_attention`` and ``pallas_attention``. Its Pallas kernels are
the CUDA kernels of ``csrc/attention.cu`` and ``csrc/attention_hm.cu``:

- K1 ``attention_fwd_kernel`` (``_pallas_fwd_tm``) and K2
  ``attention_bwd_kernel`` (``_pallas_bwd_tm``): token-major, reading the
  packed qkv in place; every head width that divides 128, as the JAX
  token-major kernel (``tm_kernel_takes``);
- K5 ``attention_hm_fwd_kernel`` (``_pallas_fwd``) and K6
  ``attention_hm_bwd_kernel`` (``_pallas_bwd``): head-major, for the widths
  K1 does not take (ViT-H's D=80), every D, as the JAX head-major kernel
  (above 128 on the kernels' wide path, ``csrc/attention_wide.cuh``).
  K5 saves each row's softmax max and
  1/denominator, as K1 does, and K6 reads them with the output: the JAX
  VJP keeps only q, k and v and recomputes the softmax, the port's kernels
  take the saved-statistics form (``attention_hm_bwd_stats_reference``) of
  the same gradients. On the CPU the autograd Function keeps the JAX form
  (``attention_hm_bwd_reference``).

This module holds their wrappers, their plain PyTorch versions and the
autograd Functions that join them. The qkv channel order is (3, H, D), the
layout of the fused ``qkv`` projection's output; ``key_valid`` [B, N] bool
masks keys with a -1e30 bias, as the JAX package's ``_bias_from_valid`` does.
Keys past N are masked inside the kernels: the JAX package's row padding is
TPU tiling. (It shows in one corner only: a row whose keys are all invalid
averages v over its N keys here, over the padded keys too in JAX.)

``attention_route`` is the dispatch. On a CPU tensor each route takes its
plain version; on a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from avsiam_tpu_torch import kernels

NEG_INF = -1e30
LANE = 128
ATTN_IMPLS = ("auto", "pallas", "xla")


def tm_kernel_takes(D: int) -> bool:
    """Whether K1/K2 take head width D: every D that divides 128, the
    widths of the JAX token-major kernel (``avsiam_tpu/ops/attention.py:744``,
    which also needs C % 128 == 0)."""
    return D > 0 and LANE % D == 0


def attention_route(impl: str, C: int, num_heads: int) -> str:
    """Which path ``attention_qkv`` takes, as
    ``avsiam_tpu/ops/attention.py:741-757`` decides: where the shape is
    token-major (``tm_ok``: C % 128 == 0 and 128 % D == 0), 'token_major'
    (K1/K2, which take every such D) under 'pallas' and 'auto'; elsewhere
    'head_major' (K5/K6) under 'pallas' and 'xla' under 'auto' (the JAX
    'auto' is XLA there); 'xla' under 'xla'. On a CPU tensor every route
    takes its plain version; on the card the kernels, which take every D
    of their routes."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {impl!r} not in {ATTN_IMPLS}")
    D = C // num_heads
    if impl == "xla":
        return "xla"
    if C % LANE == 0 and LANE % D == 0:
        return "token_major"
    return "head_major" if impl == "pallas" else "xla"


def _key_bias(key_valid: torch.Tensor) -> torch.Tensor:
    """[B, N] float32: 0 for a valid key, -1e30 for a masked one."""
    return torch.zeros(key_valid.shape, dtype=torch.float32,
                       device=key_valid.device).masked_fill(~key_valid,
                                                            NEG_INF)


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
        s = s + _key_bias(key_valid)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return out.reshape(B, N, C).to(xqkv.dtype)


def _geometry(xqkv: torch.Tensor, num_heads: int,
              key_valid: Optional[torch.Tensor]):
    """Validate a kernel call; returns (B, N, H, D)."""
    if xqkv.dim() != 3 or xqkv.shape[2] % (3 * num_heads) != 0:
        raise ValueError(f"xqkv must be [B, N, 3*H*D], got {tuple(xqkv.shape)}"
                         f" for {num_heads} heads")
    B, N, C3 = xqkv.shape
    D = C3 // (3 * num_heads)
    if not tm_kernel_takes(D):
        raise ValueError(f"attention kernel takes head dims that divide "
                         f"{LANE}, got {D}")
    if xqkv.device.type != "cuda":
        raise ValueError(f"attention kernel needs a CUDA tensor, got "
                         f"{xqkv.device}")
    if xqkv.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"attention kernel takes float32 or bfloat16, got "
                         f"{xqkv.dtype}")
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


# ------------------------------------------------------------ XLA form
def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's XLA attention on q, k, v [B, N, H, D]: scores in
    float32 from the operands' values, softmax in float32, p cast to v's
    dtype before the PV product, output in q's dtype. Torch ops; autograd
    gives its backward."""
    p = torch.softmax(_hm_scores(q, k, key_valid), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _hm_scores(q, k, key_valid):
    """Scaled, biased scores [B, H, N, N] in float32 from q, k [B, N, H, D]
    (the products of their values, as bf16 operands with float32
    accumulation give them)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * q.shape[-1] ** -0.5
    if key_valid is not None:
        s = s + _key_bias(key_valid)[:, None, None, :]
    return s


# ------------------------------------------------------------- K5, K6
def _hm_softmax_e(q, k, key_valid):
    """(e, r) of ``_attn_bwd_math`` per (b, h): e = exp(s * scale + bias -
    max) [B, H, N, N] and r = 1 / rowsum(e) [B, H, N, 1], in float32."""
    s = _hm_scores(q, k, key_valid)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e, 1.0 / e.sum(dim=-1, keepdim=True)


def attention_hm_reference(q, k, v, key_valid=None):
    """Plain version of K5 (``_attn_fwd_math``) on q, k, v [B, N, H, D]:
    o = (e v) / rowsum(e) with e cast to v's dtype before the product; output
    [B, N, H, D] in q's dtype."""
    f32 = torch.float32
    e, r = _hm_softmax_e(q, k, key_valid)
    o = torch.einsum("bhqk,bkhd->bhqd", e.to(v.dtype).to(f32), v.to(f32)) * r
    return o.transpose(1, 2).contiguous().to(q.dtype)


def attention_hm_bwd_reference(q, k, v, do, key_valid=None):
    """Plain version of K6 (``_attn_bwd_math``, in its casts): (dq, dk, dv)
    [B, N, H, D] in q's dtype from q, k, v and the output's cotangent do."""
    f32 = torch.float32
    qd, vd = q.dtype, v.dtype
    scale = q.shape[-1] ** -0.5
    e, r = _hm_softmax_e(q, k, key_valid)
    do_h = do.to(f32).transpose(1, 2)  # [B, H, N, D]
    q_h, k_h, v_h = (t.to(f32).transpose(1, 2) for t in (q, k, v))
    dor = (r * do_h).to(vd).to(f32)
    dv = e.to(vd).to(f32).transpose(-1, -2) @ dor
    dp = do_h.to(vd).to(f32) @ v_h.transpose(-1, -2)
    c = r * (dp * e).sum(dim=-1, keepdim=True)
    es = (e * (dp - c)).to(qd).to(f32)
    dq = (es @ k_h) * (scale * r)
    qr = (r * q_h).to(qd).to(f32)
    dk = (es.transpose(-1, -2) @ qr) * scale
    return tuple(g.transpose(1, 2).contiguous().to(qd) for g in (dq, dk, dv))


def attention_hm_stats_reference(q, k, key_valid=None):
    """Plain version of K5's saved statistics: [B, H, N, 2] float32, each
    row's max of s * scale + bias and 1 / rowsum(exp(s * scale + bias -
    max))."""
    s = _hm_scores(q, k, key_valid)
    m = s.amax(dim=-1)
    r = 1.0 / torch.exp(s - m[..., None]).sum(dim=-1)
    return torch.stack((m, r), dim=-1)


def attention_hm_bwd_stats_reference(q, k, v, out, stats, do,
                                     key_valid=None):
    """Plain version of K6 as its kernels compute it, from K5's output and
    saved statistics: (dq, dk, dv) [B, N, H, D] in q's dtype. With (m, r) =
    stats, p = exp(s * scale + bias - m) * r, dp = do v^T, delta =
    rowsum(do * out), ds = p * (dp - delta); dq = scale * ds k, dk = scale *
    ds^T q, dv = p^T do, with p and ds rounded to q's dtype before their
    products (the kernels round them to bf16). The same function as
    ``attention_hm_bwd_reference``: rowsum(p * dp) = rowsum(do * out)."""
    f32 = torch.float32
    qd = q.dtype
    scale = q.shape[-1] ** -0.5
    q_h, k_h, v_h, o_h, do_h = (t.to(f32).transpose(1, 2)
                                for t in (q, k, v, out, do))  # [B, H, N, D]
    m, r = stats[..., :1], stats[..., 1:]
    p = torch.exp(_hm_scores(q, k, key_valid) - m) * r
    dp = do_h @ v_h.transpose(-1, -2)
    delta = (do_h * o_h).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(qd).to(f32)
    p = p.to(qd).to(f32)
    dq = (ds @ k_h) * scale
    dk = (ds.transpose(-1, -2) @ q_h) * scale
    dv = p.transpose(-1, -2) @ do_h
    return tuple(g.transpose(1, 2).contiguous().to(qd) for g in (dq, dk, dv))


def _hm_geometry(q, k, v, key_valid):
    """Validate a K5/K6 call; returns (B, N, H, D, batch stride, row
    stride): the shape and dtype first, then the device."""
    if q.dtype not in kernels.DTYPE_CODES or q.dim() != 4:
        raise ValueError(f"q must be [B, N, H, D] float32 or bfloat16, got "
                         f"{tuple(q.shape)} {q.dtype}")
    B, N, H, D = q.shape
    if D == 0 or B == 0 or N == 0:
        raise ValueError(f"head-major attention kernel takes a non-empty "
                         f"batch of non-empty heads, got {tuple(q.shape)}")
    if q.device.type != "cuda":
        raise ValueError(f"head-major attention kernel needs a CUDA tensor, "
                         f"got {q.device}")
    sB, sN, sH, sD = q.stride()
    for name, t in (("k", k), ("v", v)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or t.stride() != q.stride()):
            raise ValueError(f"{name} must match q's shape, dtype, device and "
                             f"strides")
    # the kernels read rows in 16-byte pieces where the strides and the
    # data's alignment allow it, else value by value
    if sD != 1 or sH != D:
        raise ValueError("q, k, v must have unit channel stride and head "
                         "stride D")
    if key_valid is not None and (
            key_valid.shape != (B, N) or key_valid.dtype != torch.bool
            or key_valid.device != q.device
            or not key_valid.is_contiguous()):
        raise ValueError("key_valid must be a contiguous [B, N] bool tensor "
                         "on the same device")
    return B, N, H, D, sB, sN


def attention_hm_fwd_kernel(q, k, v, key_valid=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 on q, k, v [B, N, H, D] sharing strides (e.g. the three slices of
    a packed [B, N, 3, H, D] qkv): (out, contiguous [B, N, H, D] in q's
    dtype; stats [B, H, N, 2] f32 = per-row softmax max and 1/denominator,
    K6's input)."""
    B, N, H, D, sB, sN = _hm_geometry(q, k, v, key_valid)
    lib = kernels.library()
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    stats = torch.empty((B, H, N, 2), dtype=torch.float32, device=q.device)
    err = lib.avsiam_attn_hm_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if key_valid is None else key_valid.data_ptr(), out.data_ptr(),
        stats.data_ptr(), B, N, H, D, sB, sN, kernels.DTYPE_CODES[q.dtype],
        D ** -0.5, kernels.stream_handle(q))
    kernels.check(err, "head-major attention forward")
    kernels.LAUNCHES["attention_hm_fwd"] += 1
    return out, stats


def attention_hm_bwd_kernel(q, k, v, out, stats, do, key_valid=None):
    """K6: (dq, dk, dv), each contiguous [B, N, H, D] in q's dtype, from q,
    k, v (as K5 takes them), K5's output and statistics, and the output's
    contiguous cotangent do. One call runs the dq kernel (which also forms
    delta = rowsum(do * out)) and the dk/dv kernel."""
    B, N, H, D, sB, sN = _hm_geometry(q, k, v, key_valid)
    for name, t, shape, dtype in (
            ("out", out, (B, N, H, D), q.dtype),
            ("do", do, (B, N, H, D), q.dtype),
            ("stats", stats, (B, H, N, 2), torch.float32)):
        if (t.shape != shape or t.dtype != dtype or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous 16-byte aligned "
                             f"{shape} {dtype} tensor on {q.device}")
    lib = kernels.library()
    delta = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    err = lib.avsiam_attn_hm_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if key_valid is None else key_valid.data_ptr(), out.data_ptr(),
        do.data_ptr(), stats.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, N, H, D, sB, sN,
        kernels.DTYPE_CODES[q.dtype], D ** -0.5, kernels.stream_handle(q))
    kernels.check(err, "head-major attention backward")
    kernels.LAUNCHES["attention_hm_bwd"] += 1
    return dq, dk, dv


class _HeadMajorAttention(torch.autograd.Function):
    """K5 forward, K6 backward; their JAX-form plain versions on the CPU,
    which save only q, k, v and key_valid, as the JAX VJP does. On the card
    the output and K5's statistics are saved too: the output is the tensor
    returned (its storage, no copy) and the statistics [B, H, N, 2] f32."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid):
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, key_valid)
            return attention_hm_reference(q, k, v, key_valid)
        out, stats = attention_hm_fwd_kernel(q, k, v, key_valid)
        ctx.save_for_backward(q, k, v, key_valid, out, stats)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_valid, *saved = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = attention_hm_bwd_reference(q, k, v, do, key_valid)
        else:
            grads = attention_hm_bwd_kernel(q, k, v, *saved, do.contiguous(),
                                            key_valid)
        return (*grads, None)


def pallas_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Head-major attention on q, k, v [B, N, H, D] -> [B, N, H, D]: K5 and
    K6 on the card, their plain versions on the CPU. The JAX ``block_q`` and
    heads-per-program are TPU tiling and are not taken."""
    return _HeadMajorAttention.apply(q, k, v, key_valid)


def attention_qkv(xqkv: torch.Tensor, num_heads: int,
                  key_valid: Optional[torch.Tensor] = None,
                  impl: str = "auto") -> torch.Tensor:
    """Attention on the packed qkv projection [B, N, 3C] -> [B, N, C] by
    ``attention_route``: K1/K2 (the plain version on a CPU tensor), K5/K6 on
    the [B, N, 3, H, D] views of xqkv, or ``xla_attention``."""
    B, N, C3 = xqkv.shape
    C = C3 // 3
    route = attention_route(impl, C, num_heads)
    if route == "token_major":
        if xqkv.device.type == "cpu":
            return attention_reference(xqkv, num_heads, key_valid)
        return _AttentionKernel.apply(xqkv, key_valid, num_heads)
    q, k, v = xqkv.reshape(B, N, 3, num_heads, C // num_heads).unbind(2)
    attend = pallas_attention if route == "head_major" else xla_attention
    return attend(q, k, v, key_valid).reshape(B, N, C)
