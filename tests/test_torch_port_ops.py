"""Port parity of the plain ops: patchify, gathers, masking, GELU, LayerNorm,
contrastive loss, optimizer schedule, parameter groups and configs.

Inputs are made with numpy from a seed and fed to the JAX function and its
``avsiam_tpu_torch`` counterpart; everything runs in float32 on the CPU.
Index-valued results (patch layout, gathers, keep sets) must match exactly;
float tolerances are stated per test.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsiam_tpu import configs as jc
from avsiam_tpu.models.cavmae import chunk_sizes as j_chunk_sizes
from avsiam_tpu.ops import contrastive as jcon
from avsiam_tpu.ops import gather as jga
from avsiam_tpu.ops import gelu as jgelu
from avsiam_tpu.ops import layernorm as jln
from avsiam_tpu.ops import masking as jmk
from avsiam_tpu.train import optim as joptim
from avsiam_tpu.train import param_groups as jpg
from avsiam_tpu_torch import configs as pc
from avsiam_tpu_torch.models.cavmae import chunk_sizes
from avsiam_tpu_torch.ops import contrastive as con
from avsiam_tpu_torch.ops import gather as ga
from avsiam_tpu_torch.ops import gelu as pgelu
from avsiam_tpu_torch.ops import layernorm as ln
from avsiam_tpu_torch.ops import masking as mk
from avsiam_tpu_torch.ops import patchify as pa
from avsiam_tpu_torch.train import optim as poptim
from avsiam_tpu_torch.train import param_groups as ppg
from avsiam_tpu_torch.utils.weights import port_name
from test_torch_port_common import jax_param_paths

# the JAX ops package re-exports a function named patchify
jpa = importlib.import_module("avsiam_tpu.ops.patchify")
RS = np.random.RandomState(0)
T = torch.from_numpy


def _f32(*shape):
    return RS.randn(*shape).astype(np.float32)


# --------------------------------------------------------------- patchify
def test_patchify_roundtrip_matches_jax():
    img = _f32(2, 3, 48, 32)
    ours = pa.patchify(T(img), 16)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jpa.patchify(img, 16)))
    back = pa.unpatchify(ours, 3, 3, 2, 16)
    np.testing.assert_array_equal(back.numpy(), img)
    fb = _f32(2, 128, 32)
    np.testing.assert_array_equal(pa.audio_to_image(T(fb)).numpy(),
                                  np.asarray(jpa.audio_to_image(fb)))


# ----------------------------------------------------------------- gather
def test_gathers_clamp_out_of_range_ids_like_jax():
    x = _f32(3, 7, 5)
    ids = np.array([[0, 6, 7, 9], [3, 3, 1, 8], [6, 5, 4, 0]], np.int32)
    np.testing.assert_array_equal(
        ga.take_tokens(T(x), T(ids).long()).numpy(),
        np.asarray(jga.take_tokens(x, ids, impl="gather")))
    bids = np.array([2, 0, 5, 1], np.int32)
    np.testing.assert_array_equal(
        ga.take_batch(T(x), T(bids).long()).numpy(),
        np.asarray(jga.take_batch(x, bids, impl="gather")))


# ---------------------------------------------------------------- masking
@pytest.mark.parametrize("L", [512, 196, 16, 9])
def test_len_keep_for_matches_jax(L):
    for ratio in [0.2 * i for i in range(5)] + [0.75, 0.25]:
        assert mk.len_keep_for(L, ratio) == jmk.len_keep_for(L, ratio)
    assert mk.len_keep_for(512, 0.2 * 3) == 204  # int(512 * 0.3999...)


def test_random_masking_matches_jax_with_ties():
    x = _f32(4, 50, 6)
    # quantised noise forces ties: the kept set then depends on stability
    noise = np.round(RS.rand(4, 50) * 8).astype(np.float32) / 8
    ours = mk.random_masking(T(x), 20, T(noise))
    ref = jmk.random_masking(None, x, 20, noise=noise)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _jax_structured_uniforms(rng, N, f, t):
    k_base, k_t, k_f = jax.random.split(rng, 3)  # as jmk.structured_noise
    return (np.array(jax.random.uniform(k_base, (N, f, t))),
            np.array(jax.random.uniform(k_t, (N, t))),
            np.array(jax.random.uniform(k_f, (N, f))))


@pytest.mark.parametrize("ratio", [0.2 * i for i in range(5)] + [0.75])
def test_structured_noise_matches_jax(ratio):
    rng = jax.random.PRNGKey(int(ratio * 100))
    N, f, t = 3, 8, 64
    base, r_t, r_f = _jax_structured_uniforms(rng, N, f, t)
    ours = mk.structured_noise(T(base), T(r_t), T(r_f), ratio)
    ref = jmk.structured_noise(rng, N, f, t, ratio, mode="tf")
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("ratio", [0.2, 0.4, 0.6])
def test_random_masking_structured_keeps_the_jax_set(ratio):
    """'tf' boosting marks more tokens than the ratio removes at these ratios
    (about 1.4r - 0.49r^2 > r), so ties at 1.1 decide which boosted tokens
    are kept: only a stable sort reproduces JAX's keep set."""
    rng = jax.random.PRNGKey(7)
    N, f, t = 4, 8, 64
    x = _f32(N, f * t, 3)
    k_noise, k_sets = jax.random.split(rng)
    base, r_t, r_f = _jax_structured_uniforms(k_sets, N, f, t)
    boosted = mk.structured_noise(T(base), T(r_t), T(r_f), ratio) == 1.1
    removed = f * t - mk.len_keep_for(f * t, ratio)
    assert (boosted.sum(dim=1) > removed).all()  # the trap is live
    ours = mk.random_masking_structured(T(x), ratio, t, f, T(base), T(r_t),
                                        T(r_f))
    ref = jmk.random_masking_structured(rng, x, ratio, t=t, f=f, mode="tf")
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_masked_mean_matches_jax():
    x = _f32(3, 11, 4)
    keep = RS.rand(3, 11) > 0.4
    np.testing.assert_allclose(mk.masked_mean(T(x), T(keep)).numpy(),
                               np.asarray(jmk.masked_mean(x, keep)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("batch", [1, 5, 8, 9, 13, 64])
def test_chunk_sizes_match_jax(batch):
    assert chunk_sizes(batch, 5) == j_chunk_sizes(batch, 5)


# ------------------------------------------------------------------- gelu
@pytest.mark.parametrize("impl", pgelu.GELU_IMPLS)
def test_gelu_matches_jax(impl):
    """float32 GELU, its derivative and the (act, grad) pair of every form
    against the JAX package: values to 1e-6 (erf polynomial differences,
    f32 reassociation). The derivatives of 'tanh' and 'tanh5' to 5e-6: the
    JAX CPU tanh saturates to exactly 1 from about 7.9 on, where torch's
    is 1 - 2^-22, and the derivative's 0.5 x (1 - t^2) (...) term carries
    that as up to 4e-6 at |x| near 5."""
    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    gtol = 5e-6 if impl in ("tanh", "tanh5") else 1e-6
    np.testing.assert_allclose(pgelu.gelu_f32(T(x), impl).numpy(),
                               np.asarray(jgelu.gelu_f32(x, impl)), atol=1e-6)
    np.testing.assert_allclose(pgelu.gelu_grad_f32(T(x), impl).numpy(),
                               np.asarray(jgelu.gelu_grad_f32(x, impl)),
                               atol=gtol)
    act, grad = pgelu.gelu_act_grad_f32(T(x), impl)
    jact, jgrad = jgelu.gelu_act_grad_f32(x, impl)
    np.testing.assert_allclose(act.numpy(), np.asarray(jact), atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=gtol)


def _bf16_grid():
    """Every finite bfloat16 value, as float32."""
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    x = bits.view(np.float32)
    return x[np.isfinite(x)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", pgelu.GELU_IMPLS)
def test_dense_gelu_matches_jax_in_its_dtype(impl, dtype):
    """The dense route's ``gelu`` against the JAX ``gelu`` in x's dtype, in
    the JAX operation order, over every finite bf16 value (and those values
    in float32). bfloat16: each output within one bf16 ulp of JAX's (ulps of
    the larger magnitude) or within 1e-6 of it, the float32 tolerance: two
    f32 tanh implementations part in 'tanh5''s cancelling tail (1 + tanh
    near -1, where the form's own erf error is 3e-6), and XLA on the CPU
    flushes subnormal intermediates to zero. float32: within 1e-6 relative
    or absolute (erfc and tanh implementations differ by an ulp or two)."""
    x = _bf16_grid()
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jgelu.gelu(jnp.asarray(x).astype(jdt), impl)
                      .astype(jnp.float32))
    got = pgelu.gelu(T(x).to(getattr(torch, dtype)), impl).float().numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    mag = np.maximum(np.abs(got), np.abs(want))
    if dtype == "bfloat16":
        mag = np.maximum(mag, np.finfo(np.float32).tiny)
        tol = np.maximum(2.0 ** (np.floor(np.log2(mag)) - 7), 1e-6)
    else:
        tol = np.maximum(1e-6 * mag, 1e-6)
    assert (np.abs(got - want) <= tol).all()


def test_kernel_gelu_is_ans_within_erf_gap():
    from avsiam_tpu.ops.mlp import _kernel_impl
    assert pgelu.kernel_impl("erf") == _kernel_impl("erf") == "ans"
    for impl in ("tanh", "ans", "cheb", "tanh5"):
        assert pgelu.kernel_impl(impl) == _kernel_impl(impl) == impl
    x = T(np.linspace(-8, 8, 4001, dtype=np.float32))
    gap = (pgelu.gelu_f32(x, "ans") - pgelu.gelu_f32(x, "erf")).abs().max()
    assert gap <= 1.5e-7 * 8 + 1e-6  # |x| * max erf error, plus f32 rounding
    with pytest.raises(ValueError):  # a form neither package takes
        pgelu.gelu_f32(x, "relu")
    with pytest.raises(ValueError):
        pgelu.kernel_impl("relu")


# -------------------------------------------------------------- layernorm
def test_layer_norm_forward_and_vjp_match_jax():
    """Forward to 1e-5 and the analytic VJP to 1e-4 (f32); the port's
    formula is flax's, not torch's (checked: they differ by > 0 here)."""
    x = (_f32(5, 7, 96) * 3 + 1.5)
    g, b = _f32(96), _f32(96)
    dy = _f32(5, 7, 96)
    ours = ln.layer_norm(T(x), T(g), T(b), 1e-6)
    ref = jln._ln_fwd_math(x, g, b, 1e-6)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    dx, dg, db = ln.layer_norm_vjp(T(x), T(g), T(dy), 1e-6)
    jdx, jdg, jdb = jln._ln_bwd_math(x, g, dy, 1e-6)
    for a, r in ((dx, jdx), (dg, jdg), (db, jdb)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)
    # autograd through the port's forward agrees with JAX's VJP
    xt, gt, bt = (T(a).requires_grad_(True) for a in (x, g, b))
    ln.layer_norm(xt, gt, bt, 1e-6).backward(T(dy))
    _, vjp = jax.vjp(lambda x, g, b: jln.layer_norm_fp32(x, g, b, 1e-6),
                     x, g, b)
    for a, r in zip((xt.grad, gt.grad, bt.grad), vjp(dy)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)


# ------------------------------------------------------------ contrastive
@pytest.mark.parametrize("bidirect", [True, False])
def test_info_nce_matches_jax(bidirect):
    a, v = _f32(9, 32), _f32(9, 32)
    loss, acc = con.info_nce_gathered(T(a), T(v), 0.05, bidirect)
    jloss, jacc = jcon.info_nce_gathered(a, v, 0.05, bidirect)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(acc) == float(jacc)
    np.testing.assert_allclose(con.l2_normalize(T(a)).numpy(),
                               np.asarray(jcon.l2_normalize(a)), rtol=1e-6,
                               atol=1e-7)


# ----------------------------------------------- optimizer, groups, configs
def test_multistep_lr_factor_matches_jax():
    for e in range(1, 60):
        assert poptim.multistep_lr_factor(e, 10, 5, 0.5) == \
            joptim.multistep_lr_factor(e, 10, 5, 0.5)


@pytest.mark.parametrize("which", ["contrastive", "mae"])
def test_touched_sets_match_jax(which):
    jpred = {"contrastive": jpg.touched_contrastive, "mae": jpg.touched_mae}
    ppred = {"contrastive": ppg.touched_contrastive, "mae": ppg.touched_mae}
    paths = jax_param_paths()
    n_true = 0
    for path in paths:
        name, _ = port_name(tuple(path.split("/")))
        assert ppred[which](name) == jpred[which](path), (path, name)
        n_true += jpred[which](path)
    assert 0 < n_true < len(paths)


@pytest.mark.parametrize("name", ["ViTConfig", "DecoderConfig", "CAVMAEConfig",
                                  "OptimizerConfig", "PretrainConfig"])
def test_config_fields_and_defaults_match_jax(name):
    jf = {f.name: f for f in dataclasses.fields(getattr(jc, name))}
    pf = {f.name: f for f in dataclasses.fields(getattr(pc, name))}
    assert list(jf) == list(pf)
    jd, pd = getattr(jc, name)(), getattr(pc, name)()
    for k in jf:
        if k == "dtype":
            assert pd.dtype == torch.float32 and jd.dtype == jnp.float32
        elif not dataclasses.is_dataclass(getattr(jd, k)):
            assert getattr(pd, k) == getattr(jd, k), k
