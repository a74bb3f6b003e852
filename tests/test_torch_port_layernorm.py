"""Port parity of the LayerNorm backward (kernel K10 on the GPU) and of
``LayerNormFP32`` under ``AVSIAM_LN=pallas``.

On the CPU the port's ``ln_bwd_reference`` is held against the JAX
package's Pallas ``_ln_bwd_pallas`` in interpret mode, and the module
against the JAX module with ``avsiam_tpu.ops.layernorm.LN_IMPL`` set to
'pallas' (pytest monkeypatch; the JAX module reads it at each call, and
nothing in the JAX package changes). Off a TPU the JAX custom VJP takes its
analytic backward, which the port's CPU path mirrors. The kernel itself runs
only on a card: ``tests/test_torch_port_cuda.py`` and ``python3
chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avsiam_tpu.ops.layernorm as jln
from avsiam_tpu.models.layers import LayerNormFP32 as JaxLayerNorm
from avsiam_tpu_torch import kernels
from avsiam_tpu_torch.models import layers as players
from avsiam_tpu_torch.ops import layernorm as pln
from avsiam_tpu_torch.utils.weights import params_from_jax

EPS = 1e-5


def _rows(R, C, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(R, C).astype(np.float32),
            rs.randn(R, C).astype(np.float32),
            (1.0 + 0.2 * rs.randn(C)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [128, 256])
@pytest.mark.parametrize("R", [37, 64])
def test_ln_bwd_reference_matches_jax_pallas(R, C, dtype):
    """dx to 1e-5 in float32 and to one bf16 rounding (8e-3 of its largest
    value) in bfloat16, where the two round the same float32 value after
    sums taken in another order; dgamma and dbeta (float32) to 1e-5 of
    their largest value."""
    x, dy, scale = _rows(R, C, seed=R + C)
    jx = jnp.asarray(x).astype(dtype)
    jdy = jnp.asarray(dy).astype(dtype)
    jdx, jdg, jdb = jln._ln_bwd_pallas(jx, jdy, jnp.asarray(scale), EPS)
    tdt = getattr(torch, dtype)
    dx, dg, db = pln.ln_bwd_reference(
        torch.from_numpy(np.asarray(jx, np.float32)).to(tdt),
        torch.from_numpy(np.asarray(jdy, np.float32)).to(tdt),
        torch.from_numpy(scale), EPS)
    assert dx.dtype == tdt and dg.dtype == db.dtype == torch.float32
    want = np.asarray(jdx, np.float32)
    tol = 1e-5 if dtype == "float32" else 8e-3 * np.abs(want).max()
    np.testing.assert_allclose(dx.float().numpy(), want, rtol=1e-5, atol=tol)
    for got, w in ((dg, jdg), (db, jdb)):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_fp32_module_matches_jax(monkeypatch, dtype):
    """``LayerNormFP32`` under ``AVSIAM_LN=pallas`` against the JAX module
    in its custom-VJP branch, x and the module in ``dtype``: output and
    gradients of x, scale and bias to 1e-5 of their largest value in
    float32 (the row sums run in another order), output and dx to one bf16
    rounding (8e-3) in bfloat16."""
    monkeypatch.setattr(jln, "LN_IMPL", "pallas")
    monkeypatch.setenv("AVSIAM_LN", "pallas")
    rs = np.random.RandomState(5)
    x = rs.randn(3, 45, 128).astype(np.float32)
    ct = rs.randn(3, 45, 128).astype(np.float32)
    jdt = getattr(jnp, dtype)
    m = JaxLayerNorm(128, epsilon=EPS, dtype=jdt)
    params = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 128), jdt))["params"]
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rs.randn(*a.shape), jnp.float32),
        params)
    jx = jnp.asarray(x).astype(jdt)

    def loss(p, x):
        out = m.apply({"params": p}, x)
        return jnp.sum(out.astype(jnp.float32) * ct), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(loss, argnums=(0, 1),
                                               has_aux=True)(params, jx)
    tdt = getattr(torch, dtype)
    mod = players.LayerNormFP32(128, EPS, tdt, "cpu")
    mod.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    xt = torch.from_numpy(np.asarray(jx, np.float32)).to(tdt)
    xt.requires_grad_(True)
    out = mod(xt)
    (out.float() * torch.from_numpy(ct)).sum().backward()
    assert out.dtype == tdt and xt.grad.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 8e-3
    for got, want in ((out, jout), (xt.grad, jgx)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max())
    jg = params_from_jax(jax.device_get(jgp))
    for name, prm in mod.named_parameters():
        w = jg[name].numpy()
        np.testing.assert_allclose(prm.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_layer_norm_flag_is_read_per_call(monkeypatch):
    """Without the flag the module differentiates its float32 ops; with it,
    the custom VJP; both give the same float32 gradients, and on CPU
    tensors neither launches a kernel."""
    mod = players.LayerNormFP32(128, EPS, torch.float32, "cpu")
    x = torch.randn((4, 7, 128), generator=torch.Generator().manual_seed(1))
    grads = []
    before = dict(kernels.LAUNCHES)
    for flag in (None, "pallas"):
        if flag is None:
            monkeypatch.delenv("AVSIAM_LN", raising=False)
        else:
            monkeypatch.setenv("AVSIAM_LN", flag)
        xt = x.clone().requires_grad_(True)
        out = mod(xt)
        is_custom = out.grad_fn.name().startswith("_LayerNormFP32")
        assert is_custom == (flag == "pallas")
        out.pow(2).sum().backward()
        grads.append(xt.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)
    assert kernels.LAUNCHES == before


def test_ln_bwd_kernel_refuses_what_it_cannot_run():
    """Off the card the wrapper raises rather than falling back."""
    x = torch.zeros((5, 128))
    with pytest.raises(ValueError, match="CUDA"):
        pln.ln_bwd_kernel(x, x, torch.ones(128), EPS)
    meta = torch.empty((5, 1536), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pln.ln_bwd_kernel(meta, meta, torch.ones(1536, device="meta"), EPS)


@pytest.mark.parametrize("R", [1, 37, 708, 5664, 100000])
def test_ln_bwd_row_tiles_cover_every_row(R):
    """K10's tiling on 132 SMs (the H100). Rows kernel: each warp walks 1-4
    rows, one while the rows fit on 32 warps an SM, and no more than spread
    them over that many warps; its blocks of 4 warps cover every row once.
    Cols kernel: 1-8 row ranges (a cluster), each of at least 16 rows where
    there are that many, and all of them holding rows."""
    sms, per_sm = 132, pln.LN_BWD_WARPS_PER_SM
    rpw = pln.ln_bwd_rows_per_warp(R, sms)
    per_block = pln.LN_BWD_ROW_WARPS * rpw
    blocks = -(-R // per_block)
    assert 1 <= rpw <= 4
    assert (blocks - 1) * per_block < R <= blocks * per_block
    assert (rpw == 1) == (R <= sms * per_sm)
    assert rpw == 4 or R <= sms * per_sm * rpw
    splits = pln.ln_bwd_col_splits(R)
    per_split = -(-R // splits)
    assert 1 <= splits <= pln.LN_BWD_MAX_SPLITS
    assert splits == 1 or per_split >= pln.LN_BWD_SPLIT_ROWS
    assert (splits - 1) * per_split < R <= splits * per_split
    assert splits == pln.LN_BWD_MAX_SPLITS or (
        R < (splits + 1) * pln.LN_BWD_SPLIT_ROWS)
