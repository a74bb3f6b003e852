"""Port parity of head-major attention (kernels K5/K6 on the GPU), of the
XLA form, and of ``attention_qkv``'s dispatch.

On the CPU ``pallas_attention`` runs its autograd Function with the plain
versions of K5 and K6 (``attention_hm_reference``,
``attention_hm_bwd_reference``), held here against the JAX package's
``pallas_attention`` (the Pallas ``_pallas_fwd``/``_pallas_bwd`` in
interpret mode), forward and gradients. The kernels themselves run only on a
card: ``tests/test_torch_port_cuda.py`` and ``python3 chip_smoke.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsiam_tpu_torch import kernels
from avsiam_tpu_torch.ops import attention as pat

# the module (``avsiam_tpu.ops`` re-exports a function of the same name)
jatt = importlib.import_module("avsiam_tpu.ops.attention")


def _qkv(B, N, H, D, masked, seed):
    rs = np.random.RandomState(seed)
    q, k, v, ct = (rs.randn(B, N, H, D).astype(np.float32) for _ in range(4))
    kv = None
    if masked:
        kv = rs.rand(B, N) > 0.3
        kv[:, 0] = True
    return q, k, v, ct, kv


def _jax_run(fn, arrays, ct, kv, dtype=jnp.float32):
    """(output, gradients of q, k, v) of the JAX ``fn`` under cotangent ct."""
    jkv = None if kv is None else jnp.asarray(kv)

    def loss(q, k, v):
        out = fn(q, k, v, jkv)
        return jnp.sum(out.astype(jnp.float32) * ct), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *(jnp.asarray(a).astype(dtype) for a in arrays))
    return np.asarray(out, np.float32), [np.asarray(g, np.float32)
                                         for g in grads]


def _port_run(fn, arrays, ct, kv, dtype=torch.float32):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_(True)
              for a in arrays]
    out = fn(*leaves, None if kv is None else torch.from_numpy(kv))
    (out.float() * torch.from_numpy(ct)).sum().backward()
    return out, [t.grad for t in leaves]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("N", [37, 130])
@pytest.mark.parametrize("D", [64, 80])
def test_pallas_attention_matches_jax_pallas(D, N, masked):
    """Forward to 1e-5 and dq, dk, dv to 1e-4 (float32; softmax sums run in
    another order). N=37 and 130 are ragged against the TPU's 128-row pad,
    which the port does not make."""
    q, k, v, ct, kv = _qkv(2, N, 2, D, masked, seed=N + D)
    jout, jgrads = _jax_run(jatt.pallas_attention, (q, k, v), ct, kv)
    out, grads = _port_run(pat.pallas_attention, (q, k, v), ct, kv)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5,
                               atol=1e-5)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")


def test_pallas_attention_bf16_follows_the_jax_casts():
    """In bfloat16 the plain versions round where ``_attn_fwd_math`` and
    ``_attn_bwd_math`` round: output and gradients within two bf16 roundings
    (1.6e-2 of each tensor's largest value) of the JAX kernels in interpret
    mode."""
    q, k, v, ct, kv = _qkv(2, 70, 2, 80, True, seed=3)
    ct = np.asarray(jnp.asarray(ct).astype(jnp.bfloat16), np.float32)
    jout, jgrads = _jax_run(jatt.pallas_attention, (q, k, v), ct, kv,
                            jnp.bfloat16)
    out, grads = _port_run(pat.pallas_attention, (q, k, v), ct, kv,
                           torch.bfloat16)
    assert out.dtype == torch.bfloat16
    for got, want in zip([out] + grads, [jout] + jgrads):
        assert got.dtype == torch.bfloat16
        err = np.abs(got.detach().float().numpy() - want).max()
        assert err <= 1.6e-2 * np.abs(want).max()


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_xla_attention_matches_jax_in_bf16(masked):
    """The XLA form in bfloat16: output within one bf16 rounding (8e-3 of
    its largest value) of the JAX package's; gradients (autograd here,
    XLA's autodiff there) in float32 to 1e-4."""
    q, k, v, ct, kv = _qkv(2, 45, 2, 80, masked, seed=9)
    jout, _ = _jax_run(jatt.xla_attention, (q, k, v), ct, kv, jnp.bfloat16)
    out, _ = _port_run(pat.xla_attention, (q, k, v), ct, kv, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert np.abs(out.detach().float().numpy() - jout).max() <= (
        8e-3 * np.abs(jout).max())
    jout, jgrads = _jax_run(jatt.xla_attention, (q, k, v), ct, kv)
    out, grads = _port_run(pat.xla_attention, (q, k, v), ct, kv)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5,
                               atol=1e-5)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("C,H", [(768, 12), (512, 16), (1280, 16), (160, 2),
                                 (128, 2), (96, 3), (256, 8), (256, 2),
                                 (128, 16), (128, 8), (256, 1)])
def test_attention_route_follows_the_jax_dispatch(monkeypatch, impl, C, H):
    """``attention_route`` against the branch the JAX ``attention_qkv``
    takes (``avsiam_tpu/ops/attention.py:741-759``), seen by spying on its
    three callees: token-major Pallas, head-major Pallas or XLA. D=80
    (ViT-H) and D=32 at C=96 are head-major; D=32 at C=256 token-major, and
    so are D=128 and D=8 (C=128, 16 heads)."""
    taken = []
    for name, route in (("pallas_attention_qkv", "token_major"),
                        ("pallas_attention", "head_major"),
                        ("xla_attention", "xla")):
        def spy(*args, route=route, **kw):
            taken.append(route)
            return jnp.zeros(args[0].shape[:2] + (C,) if route == "token_major"
                             else args[0].shape)
        monkeypatch.setattr(jatt, name, spy)
    jatt.attention_qkv(jnp.zeros((1, 5, 3 * C)), H, impl=impl)
    assert [pat.attention_route(impl, C, H)] == taken


@pytest.mark.parametrize("C,H,route", [
    (768, 12, "token_major"), (512, 16, "token_major"), (1280, 16, "xla"),
    (160, 2, "xla"), (96, 3, "xla"), (128, 16, "token_major"),
    (128, 8, "token_major"), (256, 2, "token_major"), (256, 1, "xla")])
def test_auto_route_is_the_kernel_or_xla(C, H, route):
    """'auto' takes K1/K2 wherever the shape is token-major (the JAX
    ``tm_ok``: D 8, 16, 64 and 128 here, every width K1/K2 take); elsewhere
    the XLA form, as the JAX 'auto' does on a TPU (off one it is always
    XLA)."""
    assert pat.attention_route("auto", C, H) == route


@pytest.mark.parametrize("case", ["d128", "d16", "d8", "d256",
                                  "d128_off_the_cpu", "unknown_impl"])
def test_pallas_route_refuses_a_width_no_kernel_takes(case):
    """Under 'pallas' no route refuses a head width: on the CPU the
    token-major route takes its plain version at every D the JAX
    ``attention_qkv`` runs, D=128 (C=256), D=16 (C=128) and D=8 (C=128)
    here, and the head-major route D=256 (C=256, one head), each held
    against it (its Pallas kernel in interpret mode; float32, with masked
    keys): output to 1e-5, d(xqkv) to 1e-4. Off the CPU K1/K2 take each
    of the token-major widths, and K5/K6 every head-major D, D=256 at
    C=256 included, as the JAX head-major kernel does: a tensor on no card
    is refused for its device alone. What is refused is an unknown
    ``attn_impl``."""
    if case == "unknown_impl":
        with pytest.raises(ValueError, match="attn_impl"):
            pat.attention_route("cudnn", 768, 12)
        return
    if case == "d128_off_the_cpu":
        assert pat.tm_kernel_takes(128) and pat.tm_kernel_takes(8)
        C, H = 256, 1
        assert pat.attention_route("pallas", C, H) == "head_major"
        x = torch.empty((2, 5, 3 * C), device="meta")
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            pat.attention_qkv(x, H, impl="pallas")
        return
    C, H = {"d16": (128, 8), "d8": (128, 16), "d128": (256, 2),
            "d256": (256, 1)}[case]
    assert pat.attention_route("pallas", C, H) == (
        "head_major" if case == "d256" else "token_major")
    B, N = 2, 37
    rs = np.random.RandomState(C + H)
    x = rs.randn(B, N, 3 * C).astype(np.float32)
    ct = rs.randn(B, N, C).astype(np.float32)
    kv = rs.rand(B, N) > 0.3
    kv[:, 0] = True

    def jloss(x):
        out = jatt.attention_qkv(x, H, key_valid=jnp.asarray(kv),
                                 impl="pallas")
        return jnp.sum(out * ct), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    out = pat.attention_qkv(xt, H, torch.from_numpy(kv), impl="pallas")
    (out * torch.from_numpy(ct)).sum().backward()
    assert kernels.LAUNCHES == before  # CPU tensors: the plain versions
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_attention_qkv_head_major_matches_jax(masked):
    """``attention_qkv`` at D=80 under 'pallas': the head-major path on the
    views of xqkv, forward to 1e-5 and d(xqkv) to 1e-4 against the JAX
    package (float32)."""
    B, N, H, D = 2, 41, 2, 80
    rs = np.random.RandomState(7)
    x = rs.randn(B, N, 3 * H * D).astype(np.float32)
    ct = rs.randn(B, N, H * D).astype(np.float32)
    kv = (rs.rand(B, N) > 0.3) if masked else None
    if masked:
        kv[:, 0] = True
    jkv = None if kv is None else jnp.asarray(kv)

    def jloss(x):
        out = jatt.attention_qkv(x, H, key_valid=jkv, impl="pallas")
        return jnp.sum(out * ct), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    out = pat.attention_qkv(xt, H, None if kv is None else
                            torch.from_numpy(kv), impl="pallas")
    (out * torch.from_numpy(ct)).sum().backward()
    assert kernels.LAUNCHES == before  # CPU tensors: the plain versions
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-4)


def test_head_major_kernels_refuse_non_cuda_tensors():
    """Off the CPU the head-major path goes to K5, which refuses a device it
    cannot run on rather than falling back; so do the wrappers."""
    x = torch.empty((2, 25, 3 * 160), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pat.attention_qkv(x, 2, impl="pallas")
    q = torch.zeros((2, 25, 2, 80))
    stats = torch.zeros((2, 2, 25, 2))
    with pytest.raises(ValueError, match="CUDA"):
        pat.attention_hm_fwd_kernel(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        pat.attention_hm_bwd_kernel(q, q, q, q, stats, q)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("D", [32, 64, 80])
def test_saved_stats_backward_matches_jax(D, masked):
    """K6's algorithm, ``attention_hm_bwd_stats_reference``: dq, dk, dv from
    the forward's output and its saved row statistics (max, 1/denominator)
    with delta = rowsum(do * out), against the JAX head-major VJP (the
    Pallas ``_pallas_bwd`` in interpret mode, which recomputes the softmax),
    in float32 to 1e-4 (the sums run in another order). The statistics come
    from ``attention_hm_stats_reference`` and reproduce the JAX forward's
    output to 1e-5."""
    q, k, v, ct, kv = _qkv(2, 53, 2, D, masked, seed=D + int(masked))
    jout, jgrads = _jax_run(jatt.pallas_attention, (q, k, v), ct, kv)
    tq, tk, tv, tct, tout = (torch.from_numpy(np.array(a))
                             for a in (q, k, v, ct, jout))
    tkv = None if kv is None else torch.from_numpy(kv)
    stats = pat.attention_hm_stats_reference(tq, tk, tkv)
    assert stats.shape == (2, 2, 53, 2) and stats.dtype == torch.float32
    p = torch.exp(pat._hm_scores(tq, tk, tkv) - stats[..., :1]) * stats[..., 1:]
    out = torch.einsum("bhqk,bkhd->bqhd", p, tv)
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-5)
    grads = pat.attention_hm_bwd_stats_reference(tq, tk, tv, tout, stats,
                                                 tct, tkv)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")
