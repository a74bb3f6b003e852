"""Port parity of the MLP family: ``fused_mlp`` ('fused', 'fbwd', 'fres' and
the split backward; kernels K4, K7, K8 and K9 on the GPU) and ``Mlp``'s
whole ``impl`` set.

On the CPU every kernel wrapper takes its plain version, so this holds the
plain versions and the autograd wiring around them against the JAX package
with its Pallas kernels in interpret mode, in float32 at D=128, H=256 (the
geometry of ``tests/test_mlp.py``), on row counts that are not multiples of
the Pallas row blocks. ``AVSIAM_MLP_BWD=split`` is set with pytest's
monkeypatch for both packages. The kernels themselves run only on a card:
``tests/test_torch_port_cuda.py`` and ``python3 chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsiam_tpu import configs as jc
from avsiam_tpu.models import CAVMAEPretrain as JaxModel
from avsiam_tpu.models.layers import Mlp as JaxMlp
from avsiam_tpu.ops.mlp import fused_ln_mlp as jax_fused_ln_mlp
from avsiam_tpu.ops.mlp import fused_mlp as jax_fused_mlp
from avsiam_tpu_torch import configs as pc
from avsiam_tpu_torch import kernels
from avsiam_tpu_torch.models import layers as players
from avsiam_tpu_torch.models.cavmae import CAVMAEPretrain
from avsiam_tpu_torch.ops import mlp as pmlp
from avsiam_tpu_torch.utils.weights import params_from_jax
from test_torch_port_common import batch, configs, process_local_compiles

D, H = 128, 256
NAMES = ("x", "w1", "b1", "w2", "b2")


@pytest.fixture(autouse=True, scope="module")
def _process_local_compiles():
    """The JAX kernels of this file compile in its own process
    (``process_local_compiles``), not from the compile cache the suite's
    workers share."""
    with process_local_compiles():
        yield


def _inputs(shape, seed):
    """JAX-layout float32 arrays: x [*shape, D], w1 [D, H], b1, w2 [H, D],
    b2, and the output cotangent ct."""
    rs = np.random.RandomState(seed)
    f = lambda *s, k=1.0: (rs.randn(*s) * k).astype(np.float32)  # noqa: E731
    return dict(x=f(*shape, D), w1=f(D, H, k=D ** -0.5), b1=f(H, k=0.1),
                w2=f(H, D, k=H ** -0.5), b2=f(D, k=0.1), ct=f(*shape, D))


def _port_leaf(p, name):
    """A port leaf from a JAX-layout array: weights in nn.Linear's layout."""
    a = p[name].T if name in ("w1", "w2") else p[name]
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)


def _port_grad(leaf, name):
    g = leaf.grad.numpy()
    return g.T if name in ("w1", "w2") else g


@pytest.mark.parametrize("shape", [(2, 37), (300,)], ids=["2x37", "300"])
@pytest.mark.parametrize("impl,split", [
    ("fused", False), ("fbwd", False), ("fres", False), ("fused", True),
    ("fbwd", True)], ids=["fused", "fbwd", "fres", "fused-split",
                          "fbwd-split"])
def test_fused_mlp_matches_jax_pallas(monkeypatch, impl, split, shape):
    """Forward to 1e-5, gradients of x, w1, b1, w2, b2 to 1e-4 (float32;
    summation order differs). The three db1s (K7's from the f32 gh, 'fres'
    and K9's from the cast gh) coincide in float32; the card's tests hold
    each kernel to its own plain version."""
    _check_fused_mlp(monkeypatch, impl, split, shape, "erf")


@pytest.mark.parametrize("gelu", ["tanh", "cheb", "tanh5"])
@pytest.mark.parametrize("impl,split", [
    ("fused", False), ("fbwd", False), ("fres", False), ("fused", True)],
    ids=["fused", "fbwd", "fres", "fused-split"])
def test_fused_mlp_gelu_forms_match_jax_pallas(monkeypatch, impl, split,
                                               gelu):
    """``test_fused_mlp_matches_jax_pallas`` under the GELU forms the MLP
    kernels run as asked ('erf' runs as 'ans'), at 300 rows: forward to
    1e-5, gradients to 1e-4."""
    _check_fused_mlp(monkeypatch, impl, split, (300,), gelu)


def _check_fused_mlp(monkeypatch, impl, split, shape, gelu):
    if split:
        monkeypatch.setenv("AVSIAM_MLP_BWD", "split")
    p = _inputs(shape, seed=sum(shape))

    def jloss(*args):
        out = jax_fused_mlp(*args, gelu=gelu, impl=impl)
        return jnp.sum(out * p["ct"]), out

    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True)(
            *(jnp.asarray(p[n]) for n in NAMES))
    leaves = {n: _port_leaf(p, n) for n in NAMES}
    out = pmlp.fused_mlp(*(leaves[n] for n in NAMES), gelu=gelu, impl=impl)
    (out * torch.from_numpy(p["ct"])).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for n, jg in zip(NAMES, jgrads):
        np.testing.assert_allclose(_port_grad(leaves[n], n), np.asarray(jg),
                                   rtol=1e-4, atol=1e-4, err_msg=n)


@pytest.mark.parametrize("shape", [(2, 37), (300,)], ids=["2x37", "300"])
def test_bf16_db1_forms_match_jax_pallas(monkeypatch, shape):
    """In bfloat16 the backward's two db1 forms part: K7 sums the float32
    gh (``avsiam_tpu/ops/mlp.py:163``), the split backward sums the gh that
    K8 stashed in bfloat16 (``:126``). The port's db1 equals the JAX
    package's bit for bit in each form, and the two forms differ."""
    p = _inputs(shape, seed=sum(shape))
    xb = p["x"].astype(jnp.bfloat16)
    ct = np.asarray(p["ct"].astype(jnp.bfloat16), np.float32)

    def jloss(x, w1, b1, w2, b2):
        out = jax_fused_mlp(x, w1, b1, w2, b2, gelu="erf", impl="fused")
        return jnp.sum(out.astype(jnp.float32) * ct)

    db1 = {}
    for split in (False, True):
        if split:
            monkeypatch.setenv("AVSIAM_MLP_BWD", "split")
        else:
            monkeypatch.delenv("AVSIAM_MLP_BWD", raising=False)
        jdb1 = jax.grad(jloss, argnums=2)(
            jnp.asarray(xb), *(jnp.asarray(p[n]) for n in NAMES[1:]))
        leaves = {n: _port_leaf(p, n) for n in NAMES[1:]}
        x = torch.from_numpy(np.asarray(xb, np.float32)).bfloat16()
        out = pmlp.fused_mlp(x, *(leaves[n] for n in NAMES[1:]), gelu="erf",
                             impl="fused")
        (out.float() * torch.from_numpy(ct)).sum().backward()
        db1[split] = _port_grad(leaves["b1"], "b1")
        np.testing.assert_array_equal(db1[split], np.asarray(jdb1),
                                      err_msg=f"split={split}")
    assert (db1[False] != db1[True]).mean() > 0.1


@pytest.mark.parametrize("shape", [(2, 37), (300,)], ids=["2x37", "300"])
@pytest.mark.parametrize("form", ["fres", "lnfres"])
def test_bf16_saved_hidden_backward_matches_jax_pallas(shape, form):
    """The 'fres' and 'lnfres' backwards in bfloat16 against the JAX
    package (``_fres_mlp_bwd``, ``_lnfres_mlp_bwd``; forwards in interpret
    mode). dh = do @ w2 stays in float32 until gelu', as in JAX, so gh, and
    with it the input's, w1's and b1's gradients, match bit for bit but for
    float32 sum-order ties: at most 1% of their elements may differ (a dh
    rounded to bf16 first makes about half of them differ). Every gradient
    lies within 1e-2 of its largest value, the LN parameters' within 1e-3."""
    p = _inputs(shape, seed=sum(shape))
    rs = np.random.RandomState(11)
    p["g"] = (1.0 + 0.1 * rs.randn(D)).astype(np.float32)
    p["bl"] = (0.1 * rs.randn(D)).astype(np.float32)
    names = ("w1", "b1", "w2", "b2")
    if form == "lnfres":
        names = ("g", "bl") + names
    xb = jnp.asarray(p["x"]).astype(jnp.bfloat16)
    ct = np.asarray(jnp.asarray(p["ct"]).astype(jnp.bfloat16), np.float32)

    def jloss(x, *params):
        if form == "fres":
            out = jax_fused_mlp(x, *params, gelu="erf", impl="fres")
        else:
            out = jax_fused_ln_mlp(x, *params, gelu="erf")
        return jnp.sum(out.astype(jnp.float32) * ct)

    jgrads = jax.grad(jloss, argnums=tuple(range(len(names) + 1)))(
        xb, *(jnp.asarray(p[n]) for n in names))
    x = torch.from_numpy(np.asarray(xb, np.float32)).bfloat16()
    x.requires_grad_(True)
    leaves = {n: _port_leaf(p, n) for n in names}
    fn = (functools.partial(pmlp.fused_mlp, impl="fres") if form == "fres"
          else pmlp.fused_ln_mlp)
    out = fn(x, *(leaves[n] for n in names), gelu="erf")
    (out.float() * torch.from_numpy(ct)).sum().backward()
    got = {"x": x.grad.float().numpy()}
    got.update({n: _port_grad(leaves[n], n) for n in names})
    for n, jg in zip(("x",) + names, jgrads):
        want = np.asarray(jg, np.float32)
        err = np.abs(got[n] - want).max() / np.abs(want).max()
        assert err <= (1e-3 if n in ("g", "bl") else 1e-2), (n, err)
        if n in ("x", "w1", "b1"):
            assert (got[n] != want).mean() <= 0.01, n


def _jax_mlp(impl, x, seed, gelu="erf"):
    """A JAX ``Mlp`` with perturbed (nonzero) biases: (params, output, the
    gradients of x and the params under a fixed cotangent)."""
    m = JaxMlp(D, H, jnp.float32, gelu, impl)
    params = m.init(jax.random.PRNGKey(seed), x)["params"]
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(a.size),
                                              a.shape), params)
    ct = jnp.asarray(np.random.RandomState(seed).randn(*x.shape)
                     .astype(np.float32))

    def loss(params, x):
        out = m.apply({"params": params}, x)
        return jnp.sum(out * ct), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                         has_aux=True)(params, x)
    return jax.device_get(params), out, grads, ct


def _port_mlp(impl, params, dtype=torch.float32, gelu="erf"):
    mlp = players.Mlp(D, H, dtype, gelu, "cpu", impl)
    mlp.load_state_dict(params_from_jax(params), strict=True)
    return mlp


@pytest.mark.parametrize("impl", players.MLP_IMPLS)
def test_mlp_every_impl_matches_jax(impl):
    """``Mlp(impl)`` against the JAX ``Mlp(impl)`` on the CPU ('auto' is
    'dense' there in both, 'lnfres' is 'fres'): output to 1e-5, gradients of
    the input and of all four parameters to 1e-4."""
    _check_mlp_impl(impl, "erf")


@pytest.mark.parametrize("gelu", ["tanh", "cheb", "tanh5"])
@pytest.mark.parametrize("impl", players.MLP_IMPLS)
def test_mlp_every_impl_every_gelu_form_matches_jax(impl, gelu):
    """``test_mlp_every_impl_matches_jax`` under the other GELU forms of
    ``ViTConfig.gelu`` ('ans' is 'erf''s kernel form): output to 1e-5,
    gradients to 1e-4."""
    _check_mlp_impl(impl, gelu)


def _check_mlp_impl(impl, gelu):
    x = np.random.RandomState(4).randn(3, 45, D).astype(np.float32)
    params, jout, (jgp, jgx), ct = _jax_mlp(impl, jnp.asarray(x), seed=2,
                                            gelu=gelu)
    mlp = _port_mlp(impl, params, gelu=gelu)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = mlp(xt)
    (out * torch.from_numpy(np.array(ct))).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-4)
    want = params_from_jax(jax.device_get(jgp))
    for name, prm in mlp.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("impl", ["remat_g", "remat_all", "fbwd"])
def test_forward_is_dense_bit_for_bit(impl, dtype):
    """'remat_g', 'remat_all' and 'fbwd' keep the 'dense' forward exactly;
    the remat forms also its gradients (the backward recomputes the same
    ops)."""
    params, *_ = _jax_mlp("dense", jnp.zeros((2, D), jnp.float32), seed=6)
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 29, D)
                         .astype(np.float32)).to(dtype)
    outs, grads = {}, {}
    for name in ("dense", impl):
        mlp = _port_mlp(name, params, dtype)
        xt = x.clone().requires_grad_(True)
        outs[name] = mlp(xt)
        outs[name].float().sum().backward()
        grads[name] = [xt.grad] + [p.grad for p in mlp.parameters()]
    assert outs[impl].dtype == dtype
    assert torch.equal(outs[impl], outs["dense"])
    if impl != "fbwd":
        for got, want in zip(grads[impl], grads["dense"]):
            assert torch.equal(got, want)


@pytest.mark.parametrize("mlp_impl,routes", [
    ("lnfres", ["fres"]), ("fused", ["fused"]), ("fres", ["fres"]),
    ("auto", []), ("dense", [])])
def test_av_tail_takes_the_mlp_route(monkeypatch, mlp_impl, routes):
    """The 'av' block tail runs its two-norm MLP through ``fused_mlp`` as
    the JAX block does (``avsiam_tpu/models/layers.py:166-175``): 'lnfres'
    as 'fres' (K4 on the card), 'auto' as 'dense' on the CPU. It never
    reaches the LN-fused ``fused_ln_mlp``."""
    seen, ln_calls = [], []
    real, real_ln = players.fused_mlp, players.fused_ln_mlp

    def spy(*args, impl, **kw):
        seen.append(impl)
        return real(*args, impl=impl, **kw)

    def ln_spy(*args, **kw):
        ln_calls.append(1)
        return real_ln(*args, **kw)

    monkeypatch.setattr(players, "fused_mlp", spy)
    monkeypatch.setattr(players, "fused_ln_mlp", ln_spy)
    blk = players.ModalityBlock(D, 2, 4.0, True, 1e-5, torch.float32, "auto",
                                "erf", mlp_impl, "cpu")
    x = torch.randn((2, 9, D), generator=torch.Generator().manual_seed(0))
    before = dict(kernels.LAUNCHES)
    a, v = blk((x[:, :4], x[:, 4:]), "av")
    assert a.shape == (2, 4, D) and v.shape == (2, 5, D)
    assert seen == routes
    assert ln_calls == []
    assert kernels.LAUNCHES == before  # CPU tensors: the plain versions


def test_fused_model_parameters_load_strictly():
    """A JAX model built with ``mlp_impl='fused'`` has the parameter tree
    of every other MLP form: it loads strictly into a port 'fused' model,
    value for value."""
    jcfg, pcfg = configs()
    jm = jc.replace(jcfg.model, mlp_impl="fused", dec_mlp_impl="fres")
    a, v = batch(2)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(JaxModel(jm).init,
                            {"params": key, "mask": key, "perm": key}, a, v)
    rs = np.random.RandomState(0)
    tree = jax.tree_util.tree_map(
        lambda s: rs.randn(*s.shape).astype(np.float32), shapes["params"])
    sd = params_from_jax(tree)
    port = CAVMAEPretrain(pc.replace(pcfg.model, mlp_impl="fused",
                                     dec_mlp_impl="fres"), "cpu")
    port.load_state_dict(sd, strict=True)
    for name, t in port.state_dict().items():
        assert torch.equal(t, sd[name]), name
    assert port.vit.blocks[0].mlp.impl == "fused"
    assert port.decoder.blocks[0].mlp.impl == "fres"


def test_block_passes_its_impl_to_the_model_parts():
    """``mlp_impl`` reaches the encoders and ``mm_layer_1/2``;
    ``dec_mlp_impl`` the decoder, falling back to ``mlp_impl``."""
    _, pcfg = configs()
    for enc, dec, want_dec in (("fbwd", "fres", "fres"),
                               ("remat_g", None, "remat_g")):
        m = CAVMAEPretrain(pc.replace(pcfg.model, mlp_impl=enc,
                                      dec_mlp_impl=dec), "cpu")
        for blk in (*m.vit.blocks, *m.ast.blocks, m.mm_layer_1,
                    m.mm_layer_2):
            assert blk.mlp.impl == blk.mlp_impl == enc
        assert all(b.mlp.impl == want_dec for b in m.decoder.blocks)


def test_cpu_tensors_take_the_plain_versions():
    """Each new wrapper, given CPU tensors, returns its plain version and
    launches nothing; given non-CPU tensors it never does."""
    p = {n: torch.from_numpy(np.ascontiguousarray(
        a.T if n in ("w1", "w2") else a)) for n, a in _inputs((5,), 1).items()}
    before = dict(kernels.LAUNCHES)
    x, w1, b1, w2, b2, do = (p[n] for n in (*NAMES, "ct"))
    assert torch.equal(pmlp.mlp_fwd(x, w1, b1, w2, b2),
                       pmlp.mlp_fwd_reference(x, w1, b1, w2, b2))
    for got, want in zip(pmlp.weight_grads(x, do),
                         pmlp.weight_grads_reference(x, do)):
        assert torch.equal(got, want)
    assert kernels.LAUNCHES == before
    meta = {n: torch.empty(t.shape, device="meta") for n, t in p.items()}
    with pytest.raises(ValueError, match="CUDA"):
        pmlp.mlp_fwd(*(meta[n] for n in NAMES))
    with pytest.raises(ValueError, match="CUDA"):
        pmlp.weight_grads(meta["x"], meta["ct"])


def test_split_backward_stashes_the_cast_gh():
    """K8's plain version stashes gh and act in x's dtype, and K9's sums the
    stash: under bfloat16 its db1 is the sum of the cast gh, while K7's sums
    the float32 gh (``avsiam_tpu/ops/mlp.py:126`` against ``:163``)."""
    p = _inputs((64,), 3)
    t = {n: torch.from_numpy(np.ascontiguousarray(
        a.T if n in ("w1", "w2") else a)).bfloat16() for n, a in p.items()}
    x, w1, b1, w2, do = (t[n] for n in ("x", "w1", "b1", "w2", "ct"))
    dx, gh, act = pmlp.mlp_bwd_dx_reference(x, w1, b1, w2, do)
    assert dx.dtype == gh.dtype == act.dtype == torch.bfloat16
    dx7, dw1, db1_f32, dw2, db2 = pmlp.mlp_bwd_reference(x, w1, b1, w2, do)
    dw1_9, db1_9 = pmlp.weight_grads_reference(x, gh)
    dw2_9, db2_9 = pmlp.weight_grads_reference(act, do)
    assert torch.equal(dx, dx7)
    assert torch.equal(dw1_9, dw1) and torch.equal(dw2_9, dw2)
    assert torch.equal(db2_9, db2)
    assert torch.equal(db1_9, gh.float().sum(dim=0))
    assert not torch.equal(db1_9, db1_f32)
    torch.testing.assert_close(db1_9, db1_f32, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("m,n,sms,want", [
    (768, 3072, 132, (192, 96)), (3072, 768, 132, (192, 96)),
    (512, 2048, 132, (128, 128)), (2048, 512, 132, (128, 128)),
    (768, 3072, 200, (128, 128)), (768, 384, 132, (128, 128)),
    (384, 3072, 132, (128, 128))])
def test_weight_grad_tile_takes_the_fewest_waves(m, n, sms, want):
    """K9's bf16 tile: 192 x 96 where it divides dw [n, m] and takes fewer
    waves * area than 128 x 128. ViT-B's widths give 128 tiles of 192 x 96,
    one wave on 132 SMs, where 128 x 128 gives 144, two waves; on 200 SMs
    both are one wave and the smaller tile is quicker, as where either fits
    in one wave (768 x 384, 384 x 3072). The decoder's widths (512, 2048) take
    128 x 128: 192 does not divide them."""
    tile = pmlp.weight_grad_tile(m, n, sms)
    assert tile == want and tile in pmlp.WEIGHT_GRAD_TILES
    assert n % tile[0] == 0 and m % tile[1] == 0


@pytest.mark.parametrize("dim,folds", [(768, True), (1024, True),
                                       (1280, True), (192, False)],
                         ids=["vit_b", "vit_l", "vit_h", "unaligned"])
def test_auto_mlp_route_takes_the_kernels_where_they_take_the_width(
        monkeypatch, dim, folds):
    """``mlp_route``: 'auto' folds the LN into K3 ('lnfres') wherever D and
    H are multiples of 128, the JAX accelerator branch's condition
    (``avsiam_tpu/models/layers.py:339-343``): at ViT-B's, ViT-L's and
    ViT-H's widths, which the MLP kernels take; at a width that is no
    multiple of 128 it runs the unfused 'dense' form. An explicit impl is
    itself. A block in 'auto' at each width runs its MLP sub-block by that
    route (on the CPU: the plain version of K3, or the dense ops)."""
    hidden = 4 * dim
    assert players.mlp_route("auto", dim, hidden) == (
        "lnfres" if folds else "dense")
    for impl in ("lnfres", "fused", "fres", "dense"):
        assert players.mlp_route(impl, dim, hidden) == impl
    seen = []
    for name in ("fused_ln_mlp", "fused_mlp"):
        real = getattr(players, name)

        def spy(*args, real=real, name=name, **kw):
            seen.append(name)
            return real(*args, **kw)

        monkeypatch.setattr(players, name, spy)
    blk = players.ModalityBlock(dim, dim // 64, 4.0, True, 1e-5,
                                torch.float32, "xla", "erf", "auto", "cpu")
    gen = torch.Generator().manual_seed(dim)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(0.02 * torch.randn(p.shape, generator=gen))
    out = blk(torch.randn((1, 5, dim), generator=gen))
    assert bool(torch.isfinite(out).all())
    assert seen == (["fused_ln_mlp"] if folds else [])


def test_lnfres_block_keeps_a_promoted_residual():
    """A float32 x through a bfloat16 'lnfres' block runs ``x + mlp(n2(x))``
    with the residual in float32, as the JAX block does
    (``avsiam_tpu/models/layers.py:344``), not the LN-fused kernel, which
    would add it in bfloat16: output in float32 and the output and the
    gradient of x within 1e-4 of their largest values of the JAX block's
    (its Pallas 'fres' kernel in interpret mode; the same bf16 roundings, so
    only the order of sums differs), where a residual added in bfloat16
    would be off by a rounding of x, about 4e-3."""
    from flax import linen as fnn

    from avsiam_tpu.models.layers import ModalityBlock as JaxBlock

    class Wrap(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            blk = JaxBlock(D, 2, 4.0, True, 1e-5, jnp.bfloat16, "xla", "erf",
                           "lnfres", name="blk")
            for m in ("a", "v"):  # materialise every norm set
                blk(x, m)
            return blk(x, None)

    rs = np.random.RandomState(11)
    x = rs.randn(2, 21, D).astype(np.float32)
    ct = rs.randn(2, 21, D).astype(np.float32)
    params = jax.device_get(
        jax.jit(Wrap().init)(jax.random.PRNGKey(2), x)["params"])

    def jloss(x):
        out = Wrap().apply({"params": params}, x)
        return jnp.sum(out.astype(jnp.float32) * ct), out

    (_, jout), jgx = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(x))
    assert jout.dtype == jnp.float32
    port = players.ModalityBlock(D, 2, 4.0, True, 1e-5, torch.bfloat16,
                                 "xla", "erf", "lnfres", "cpu")
    sd = {k.split(".", 1)[1]: t for k, t in params_from_jax(params).items()}
    port.load_state_dict(sd, strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt)
    (out * torch.from_numpy(ct)).sum().backward()
    assert out.dtype == torch.float32
    for got, want in ((out, jout), (xt.grad, jgx)):
        want = np.asarray(want, np.float32)
        err = np.abs(got.detach().numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max()
