"""Port parity of the MLP forward's two passes (K3, K4 on the card): the
plain version of the fc1 pass (the pre-GELU hidden in float32 and act
rounded to the activation dtype) and of the fc2 pass (+ b2 and, for K3, the
residual), composed, against the JAX package's Pallas kernels in interpret
mode, and the passes' grid (the fc1 pass's tiles, the fc2 pass's split of
H).

The JAX functions are ``_fwd_call`` (K4, with ``save_hpre`` False and True)
and ``_lnfwd_call`` (K3). Widths D 128 and 256 (the Pallas kernels take any
multiple of 128), H = 4 D, on a row count that is a multiple of none of the
tiles (Pallas 256, the passes' 128).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsiam_tpu.ops import mlp as jmlp
from avsiam_tpu_torch.ops import mlp as pmlp
from avsiam_tpu_torch.ops.layernorm import layer_norm

ROWS = 300
EPS = 1e-5


def _inputs(d, seed, dtype):
    """JAX-layout arrays in ``dtype``: x [ROWS, d], LN scale and bias [1,
    d], w1 [d, 4d], b1 [1, 4d], w2 [4d, d], b2 [1, d]."""
    h = 4 * d
    rs = np.random.RandomState(seed)
    f = lambda *s, k=1.0: jnp.asarray(  # noqa: E731
        (rs.randn(*s) * k).astype(np.float32)).astype(dtype)
    return dict(x=f(ROWS, d), g=1.0 + f(1, d, k=0.1), bl=f(1, d, k=0.1),
                w1=f(d, h, k=d ** -0.5), b1=f(1, h, k=0.1),
                w2=f(h, d, k=h ** -0.5), b2=f(1, d, k=0.1))


def _port(p, dtype):
    """The port's operands from JAX-layout arrays: tensors of the same
    values in ``dtype`` (LN parameters float32), weights in nn.Linear's
    layout, vectors flat."""
    t = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32)))
         for k, v in p.items()}
    return dict(x=t["x"].to(dtype), g=t["g"][0], bl=t["bl"][0],
                w1=t["w1"].T.contiguous().to(dtype), b1=t["b1"][0].to(dtype),
                w2=t["w2"].T.contiguous().to(dtype), b2=t["b2"][0].to(dtype))


def _composed(form, q):
    """(out, hidden or None) of the per-pass plain versions, composed as
    the kernels compose them: K3 normalises, then both forms run fc1 and
    fc2, K3 adding the residual."""
    rows = layer_norm(q["x"], q["g"], q["bl"], EPS) if form == "K3" else q["x"]
    hpre, act = pmlp.mlp_fc1_reference(rows, q["w1"], q["b1"])
    out = pmlp.mlp_fc2_reference(act, q["w2"], q["b2"],
                                 q["x"] if form == "K3" else None)
    return out, None if form == "K4" else hpre.to(q["x"].dtype)


def _jax(form, p):
    if form == "K3":
        return jmlp._lnfwd_call(p["x"], p["g"], p["bl"], p["w1"], p["b1"],
                                p["w2"], p["b2"], EPS, "erf")
    out = jmlp._fwd_call(p["x"], p["w1"], p["b1"], p["w2"], p["b2"], "erf",
                         save_hpre=form == "K4 with the hidden")
    return out if form != "K4" else (out, None)


def _assert_bf16_close(got, want, name):
    """bfloat16: the plain versions and the Pallas kernels take their
    float32 sums in other orders, so a value lying at a bf16 rounding tie
    may round the other way, and a flipped act moves the fc2 sums that read
    it. So at most 1% of the elements may differ, each by at most 2^-7 of
    the largest output (about two bf16 steps at its magnitude). Over seeds
    0-4 of these forms and widths, 0.01-0.26% differ, by at most 1.24 x
    2^-8 of it."""
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert (got != want).mean() <= 0.01, name
    assert np.abs(got - want).max() <= np.abs(want).max() / 2 ** 7, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("form", ["K3", "K4", "K4 with the hidden"])
def test_passes_compose_to_the_pallas_forward(form, d, dtype):
    """The fc1 and fc2 plain versions, composed, equal the port's whole
    plain version (``ln_mlp_reference`` / ``mlp_fwd_reference``) exactly,
    and the JAX kernel: float32 within 1e-5 (another summation order);
    bfloat16 as ``_assert_bf16_close`` states."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    p = _inputs(d, seed=d + len(form), dtype=jdt)
    q = _port(p, tdt)
    out, hpre = _composed(form, q)
    if form == "K3":
        whole = pmlp.ln_mlp_reference(q["x"], q["g"], q["bl"], q["w1"],
                                      q["b1"], q["w2"], q["b2"], EPS)
    else:
        whole = pmlp.mlp_fwd_reference(q["x"], q["w1"], q["b1"], q["w2"],
                                       q["b2"], save_hpre=True)
    assert out.dtype == tdt and torch.equal(out, whole[0])
    if hpre is not None:
        assert torch.equal(hpre, whole[1])
    for name, got, want in zip(("out", "hidden"), (out, hpre),
                               _jax(form, p)):
        if got is None:
            continue
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            _assert_bf16_close(got, want, name)


@pytest.mark.parametrize("rows,dim,hidden", [
    (156, 768, 3072), (1024, 768, 3072), (1416, 768, 3072),
    (5664, 512, 2048), (156, 1280, 5120), (1416, 1280, 5120),
    (37, 1024, 4096), (1, 128, 64)])
def test_forward_grid_gives_every_output_one_owner(rows, dim, hidden):
    """The forward's grid on a 132-SM card. The fc1 pass (``launch_fc1`` in
    csrc/mlp.cu) launches H / 64 hidden tiles by ceil(rows / 128) row tiles
    and each block skips its rows past ``rows``: that covers [rows, H] with
    each element in one block and no block idle, and the truncating H / 64
    loses no column because the wrappers refuse an H that is no multiple of
    64. The fc2 pass: its split of H's 64-wide slabs (``dx_splits``, as the
    dx pass splits the same product) gives each slab to one range, none
    empty, and costs no more than no split (waves x slabs per block plus the
    partial sums' traffic)."""
    owners = np.zeros((rows, hidden), dtype=int)
    for by in range(-(-rows // 128)):
        for bx in range(hidden // 64):
            r0, h0 = by * 128, bx * 64
            assert r0 < rows
            owners[r0:min(r0 + 128, rows), h0:h0 + 64] += 1
    assert (owners == 1).all()
    x = torch.empty((rows, dim), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pmlp._rows_geometry("MLP", x, torch.empty((hidden, dim),
                                                  device="meta"))
    with pytest.raises(ValueError, match="multiple of 64"):
        pmlp._rows_geometry("MLP", x, torch.empty((hidden + 32, dim),
                                                  device="meta"))
    slabs = hidden // 64
    splits = pmlp.dx_splits(rows, dim, hidden, 132)
    assert 1 <= splits <= min(slabs, pmlp.MAX_SPLITS)
    ranges = [(z * slabs // splits, (z + 1) * slabs // splits)
              for z in range(splits)]  # mlp.cu split_range
    assert all(b > a for a, b in ranges)
    assert [s for a, b in ranges for s in range(a, b)] == list(range(slabs))
    tiles = -(-rows // 128) * (dim // 128)

    def cost(k):
        extra = k * rows * dim * 8 / pmlp.PARTIAL_BYTES_PER_STEP if k > 1 else 0
        return -(-tiles * k // 132) * -(-slabs // k) + extra

    assert cost(splits) <= cost(1)
