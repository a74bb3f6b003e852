"""Port parity of the MLP backward's two passes (K7, K8 on the card): the
plain version of the gh pass (gh, act and the per-row-tile float32 column
sums of gh that K7 folds into db1) and of the dx pass, against the JAX
package's Pallas kernels in interpret mode, and the pure tiling helpers the
kernels' wrappers pick their grids with.

The JAX functions are ``_bwd_call_split`` (its ``_bwd_dx_kernel`` gives dx,
gh and act; gh and act are read off its ``pallas_call`` with pytest's
monkeypatch, nothing in the JAX package changes) and ``_bwd_call`` (the
single kernel, whose db1 sums the float32 gh). Widths D 128 and 256 (the
Pallas kernels take any multiple of 128), H = 4 D, on a row count that is
a multiple of none of the tiles (Pallas 128 and 256, the gh pass's 128).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsiam_tpu.ops import mlp as jmlp
from avsiam_tpu_torch.ops import mlp as pmlp

ROWS = 300


def _inputs(d, seed, dtype=jnp.float32):
    """JAX-layout arrays in ``dtype`` (b1 stays float32 values rounded to
    it): x [ROWS, d], w1 [d, 4d], b1 [1, 4d], w2 [4d, d], do [ROWS, d]."""
    h = 4 * d
    rs = np.random.RandomState(seed)
    f = lambda *s, k=1.0: jnp.asarray(  # noqa: E731
        (rs.randn(*s) * k).astype(np.float32)).astype(dtype)
    return dict(x=f(ROWS, d), w1=f(d, h, k=d ** -0.5), b1=f(1, h, k=0.1),
                w2=f(h, d, k=h ** -0.5), do=f(ROWS, d))


def _port(p):
    """The port's operands from JAX-layout arrays: float32 tensors of the
    same values, weights in nn.Linear's layout, b1 flat."""
    t = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32)))
         for k, v in p.items()}
    return (t["x"], t["w1"].T.contiguous(), t["b1"][0],
            t["w2"].T.contiguous(), t["do"])


def _split_kernel_outputs(monkeypatch, p):
    """(dx, gh, act) of ``_bwd_call_split``'s dx kernel, and the function's
    own (dx, dw1, db1, dw2, db2)."""
    seen = []
    real = jmlp.pl.pallas_call

    def spy(kernel, *args, **kw):
        call = real(kernel, *args, **kw)
        name = getattr(getattr(kernel, "func", kernel), "__name__", "")

        def run(*operands):
            out = call(*operands)
            if name == "_bwd_dx_kernel":
                seen.append([np.asarray(o[:ROWS].astype(jnp.float32))
                             for o in out])
            return out
        return run

    monkeypatch.setattr(jmlp.pl, "pallas_call", spy)
    grads = jmlp._bwd_call_split(p["x"], p["w1"], p["b1"], p["w2"], p["do"],
                                 "erf")
    assert len(seen) == 1
    return seen[0], [np.asarray(g.astype(jnp.float32)) for g in grads]


@pytest.mark.parametrize("d", [128, 256])
def test_gh_pass_matches_the_split_kernel(monkeypatch, d):
    """float32: the gh pass's act within 1e-5 (a forward value) and gh
    within 1e-4 (a gradient) of ``_bwd_dx_kernel``'s, the dx pass's dx
    within 1e-4 of its dx."""
    p = _inputs(d, seed=d)
    (jdx, jgh, jact), _ = _split_kernel_outputs(monkeypatch, p)
    x, w1, b1, w2, do = _port(p)
    gh, act, parts = pmlp.mlp_gh_reference(x, w1, b1, w2, do)
    assert parts.shape == (-(-ROWS // pmlp.GH_TILE), 4 * d)
    np.testing.assert_allclose(act.numpy(), jact, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gh.numpy(), jgh, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pmlp.mlp_dx_reference(gh, w1).numpy(), jdx,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [128, 256])
def test_folded_db1_matches_the_single_kernel(monkeypatch, d):
    """float32: the fold of the gh pass's row-tile sums is ``_bwd_call``'s
    db1 within 1e-4, and the plain K7 gives all five gradients within 1e-4
    of it."""
    monkeypatch.delenv("AVSIAM_MLP_BWD", raising=False)
    p = _inputs(d, seed=d + 1)
    want = [np.asarray(g) for g in jmlp._bwd_call(
        p["x"], p["w1"], p["b1"], p["w2"], p["do"], "erf")]
    x, w1, b1, w2, do = _port(p)
    _, _, parts = pmlp.mlp_gh_reference(x, w1, b1, w2, do)
    np.testing.assert_allclose(pmlp.fold_rows(parts).numpy(), want[2],
                               rtol=1e-4, atol=1e-4)
    got = pmlp.mlp_bwd_reference(x, w1, b1, w2, do)
    for name, g, w in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        if name in ("dw1", "dw2"):
            w = w.T  # nn.Linear's layout
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("d", [128, 256])
def test_bf16_db1_forms_match_jax(monkeypatch, d):
    """bfloat16: K7's db1 (the fold of the float32 gh's row-tile sums) and
    the split backward's (K9's sum of the bf16 gh the gh pass stores),
    rounded to bfloat16 as both packages hand them to b1, equal the JAX
    package's ``_bwd_call`` and ``_bwd_call_split`` db1; the two forms
    differ. Both sums run in another float32 order than JAX's, so
    an element whose sum lies at a bf16 rounding tie may round the other
    way: at most 1% of the elements may differ, each by one bf16 step (0-2
    of 512 or 1024 do over seeds 0-4). The stored gh likewise."""
    p = _inputs(d, seed=d + 2, dtype=jnp.bfloat16)
    monkeypatch.delenv("AVSIAM_MLP_BWD", raising=False)
    j7 = jmlp._bwd_call(p["x"], p["w1"], p["b1"], p["w2"], p["do"], "erf")[2]
    (_, jgh, _), j8 = _split_kernel_outputs(monkeypatch, p)
    x, w1, b1, w2, do = (t.bfloat16() for t in _port(p))
    gh, _, parts = pmlp.mlp_gh_reference(x, w1, b1.float(), w2, do)
    assert gh.dtype == torch.bfloat16
    # gh itself matches but for float32 sum-order ties at the bf16 rounding
    assert (gh.float().numpy() != jgh).mean() <= 0.01
    bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
                              .astype(jnp.float32))
    db1_7 = bf(pmlp.fold_rows(parts).numpy())
    db1_9 = bf(pmlp.weight_grads_reference(x, gh)[1].numpy())
    for got, want in ((db1_7, bf(j7)), (db1_9, bf(j8[2]))):
        off = got != want
        assert off.mean() <= 0.01
        # one bf16 step: 2^-8 of the value's binade
        assert (np.abs(got - want)[off] <= np.abs(want[off]) / 2 ** 7).all()
    assert (db1_7 != db1_9).mean() > 0.1


@pytest.mark.parametrize("rows", [1, 127, 128, 300, 1416])
def test_row_tile_sums_fold_to_the_column_sums(rows):
    """``row_tile_sums`` holds each 128-row tile's column sums (rows past
    the end count as zeros) and ``fold_rows`` adds them in tile order to
    the column sums within float32 rounding."""
    g = torch.randn((rows, 192), generator=torch.Generator().manual_seed(rows))
    parts = pmlp.row_tile_sums(g)
    assert parts.shape == (-(-rows // 128), 192)
    for i in range(parts.shape[0]):
        assert torch.equal(parts[i], g[128 * i:128 * (i + 1)].sum(dim=0))
    torch.testing.assert_close(pmlp.fold_rows(parts), g.sum(dim=0),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dim", [128, 256, 384, 512, 640, 768, 896, 1024,
                                 1152, 1280, 1536, 2048])
def test_every_128_aligned_width_is_taken(dim):
    """The width rule: every D that is a multiple of 128 (H = 4 D) passes
    the kernels' geometry check, which then wants a CUDA tensor; K3/K4's
    passes take it whole at any row count (fc2 tiles of 128 of D's columns,
    D entering fc1 only as the reduction length), the fc2 pass splitting H
    into 1 to 16 ranges."""
    assert pmlp.kernel_takes(dim, 4 * dim)
    x = torch.empty((5, dim), device="meta")
    w1 = torch.empty((4 * dim, dim), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pmlp._rows_geometry("MLP", x, w1)
    assert dim % pmlp.DX_TILE == 0
    for rows in (1, 37, 156, 1416, 5664):
        splits = pmlp.dx_splits(rows, dim, 4 * dim, 132)
        assert 1 <= splits <= min(4 * dim // 64, pmlp.MAX_SPLITS)


@pytest.mark.parametrize("dim,hidden", [(64, 256), (200, 800), (768, 96),
                                        (0, 512)])
def test_widths_the_kernels_refuse(dim, hidden):
    """D not a multiple of 128, or H not of 64, is refused before the
    device is looked at; 'auto' does not take the kernels there."""
    assert not pmlp.kernel_takes(dim, hidden)
    x = torch.empty((5, dim), device="meta")
    w1 = torch.empty((hidden, dim), device="meta")
    with pytest.raises(ValueError, match="multiple of"):
        pmlp._rows_geometry("MLP", x, w1)


@pytest.mark.parametrize("rows,dim,hidden", [
    (156, 768, 3072), (1024, 768, 3072), (1416, 768, 3072),
    (5664, 512, 2048), (156, 1280, 5120), (1416, 1280, 5120), (37, 1024, 4096),
    (1, 128, 64)])
def test_dx_splits_take_the_least_modelled_time(rows, dim, hidden):
    """The dx pass's split of H: every range holds a 64-wide slab, the split
    costs no more than none at all, and no other split count costs less
    (waves x slabs per block plus the partial sums' traffic, 132 SMs)."""
    s = pmlp.dx_splits(rows, dim, hidden, 132)
    slabs = hidden // 64
    assert 1 <= s <= min(slabs, pmlp.MAX_SPLITS)
    tiles = -(-rows // 128) * (dim // 128)

    def cost(k):
        extra = k * rows * dim * 8 / pmlp.PARTIAL_BYTES_PER_STEP if k > 1 else 0
        return -(-tiles * k // 132) * -(-slabs // k) + extra

    assert cost(s) <= cost(1)
    assert cost(s) == min(cost(k) for k in range(1, min(slabs, 16) + 1))
