"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false. The module imports no JAX, so it runs on a GPU host that has only
PyTorch; there, skip the JAX-importing ``tests/conftest.py``:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

Tolerance: max |kernel - plain| / max |plain| <= 2e-2. The kernels multiply
bf16 operands (an f32 call too) with f32 accumulation and store bf16 on the
bf16 path; the plain version runs in float32 on the same input values.
"""

import math

import pytest
import torch

from avsiam_tpu_torch import kernels
from avsiam_tpu_torch.ops import attention as pat
from avsiam_tpu_torch.ops import layernorm as pln
from avsiam_tpu_torch.ops import mlp as pmlp

pytestmark = pytest.mark.cuda
TOL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(got, want, scale=None):
    """max |got - want| / max |scale|, the scale ``want`` unless given."""
    got, want = got.detach().float(), want.detach().float()
    scale = want if scale is None else scale.detach().float()
    return float((got - want).abs().max() / scale.abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("N,H,D,masked", [
    (512, 12, 64, False), (177, 12, 64, True), (708, 16, 32, False),
    (39, 12, 64, False), (708, 16, 32, True), (1, 12, 64, False),
    (15, 16, 32, True), (65, 12, 64, True)])
def test_attention_kernels_match_plain_version(gen, dtype, N, H, D, masked):
    """K1 and K2 through ``attention_qkv`` against the plain version in
    float32 on the same values, and K1's saved statistics against
    ``attention_hm_stats_reference`` on the [B, N, 3, H, D] views, each
    column against its own scale (the max is far larger than 1/denom)."""
    x = torch.randn((2, N, 3 * H * D), generator=gen, device="cuda").to(dtype)
    ct = torch.randn((2, N, H * D), generator=gen, device="cuda").to(dtype)
    kv = None
    if masked:
        kv = torch.rand((2, N), generator=gen, device="cuda") > 0.3
        kv[:, 0] = True
    before = dict(kernels.LAUNCHES)
    xk = x.clone().requires_grad_(True)
    out = pat.attention_qkv(xk, H, kv)
    out.backward(ct)
    assert kernels.LAUNCHES["attention_fwd"] == before["attention_fwd"] + 1
    assert kernels.LAUNCHES["attention_bwd"] == before["attention_bwd"] + 1
    xr = x.float().requires_grad_(True)
    ref = pat.attention_reference(xr, H, kv)
    ref.backward(ct.float())
    assert out.dtype == dtype and xk.grad.dtype == dtype
    assert _rel(out, ref) <= TOL
    assert _rel(xk.grad, xr.grad) <= TOL
    out1, stats = pat.attention_fwd_kernel(x, H, kv)
    assert torch.equal(out1, out)
    q, k, _ = x.float().view(2, N, 3, H, D).unbind(2)
    want = pat.attention_hm_stats_reference(q, k, kv)
    assert stats.shape == want.shape == (2, H, N, 2)
    for i, name in enumerate(("max", "1/denominator")):
        assert _rel(stats[..., i], want[..., i]) <= TOL, name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("T,Dm", [(1024, 768), (37, 768), (5664, 512)])
def test_ln_mlp_kernel_matches_plain_version(gen, dtype, T, Dm):
    Hm = 4 * Dm

    def r(*shape, k=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * k

    x = r(T, Dm).to(dtype)
    w1 = r(Hm, Dm, k=Dm ** -0.5).bfloat16()
    w2 = r(Dm, Hm, k=Hm ** -0.5).bfloat16()
    b1, b2 = r(Hm, k=0.02).bfloat16().float(), r(Dm, k=0.02).bfloat16().float()
    lg, lb = 1.0 + r(Dm, k=0.1), r(Dm, k=0.1)
    out, hpre = pmlp.ln_mlp_fwd_kernel(x, lg, lb, w1, b1, w2, b2, 1e-5)
    ref, href = pmlp.ln_mlp_reference(x.float(), lg, lb, w1.float(), b1,
                                      w2.float(), b2, 1e-5)
    assert out.dtype == hpre.dtype == dtype
    assert _rel(out, ref) <= TOL
    assert _rel(hpre, href) <= TOL


def test_fused_ln_mlp_backward_on_the_card(gen):
    """The autograd Function's backward (PyTorch ops) through K3's saved
    hidden, bf16 on the card against float32 autograd of the plain version
    (gradient cosine >= 0.999 for every input)."""
    Dm, Hm = 768, 3072
    ps = [torch.randn((3, 50, Dm), generator=gen, device="cuda"),
          1.0 + 0.1 * torch.randn(Dm, generator=gen, device="cuda"),
          0.1 * torch.randn(Dm, generator=gen, device="cuda"),
          Dm ** -0.5 * torch.randn((Hm, Dm), generator=gen, device="cuda"),
          0.02 * torch.randn(Hm, generator=gen, device="cuda"),
          Hm ** -0.5 * torch.randn((Dm, Hm), generator=gen, device="cuda"),
          0.02 * torch.randn(Dm, generator=gen, device="cuda")]
    ct = torch.randn((3, 50, Dm), generator=gen, device="cuda")
    leaves = [p.clone().requires_grad_(True) for p in ps]
    out = pmlp.fused_ln_mlp(leaves[0].bfloat16(), *leaves[1:])
    out.backward(ct.bfloat16())
    ref_leaves = [p.clone().requires_grad_(True) for p in ps]
    x2 = ref_leaves[0].reshape(-1, Dm)
    ref, _ = pmlp.ln_mlp_reference(x2, *ref_leaves[1:], 1e-5)
    ref.reshape(3, 50, Dm).backward(ct)
    for got, want in zip(leaves, ref_leaves):
        cos = torch.nn.functional.cosine_similarity(
            got.grad.double().flatten(), want.grad.double().flatten(), dim=0)
        assert float(cos) >= 0.999


_NO_LAUNCHES = {k: 0 for k in kernels.LAUNCHES}


def _depth1_config(vit=None, model=None, **impls):
    """A depth-1 full-width bf16 configuration at batch 2 in the given impls
    ('exact' unless they name another contrastive form; ViT-B unless
    ``vit`` gives other ViTConfig fields, or ``model`` names a variant's
    ``pretrain_config``)."""
    from avsiam_tpu_torch.configs import (CAVMAEConfig, DecoderConfig,
                                          PretrainConfig, ViTConfig, replace)
    from avsiam_tpu_torch.models.variants import pretrain_config
    impls = dict(dict(mmixed_impl="exact"), **impls)
    if model is None:
        m = CAVMAEConfig(vit=ViTConfig(**dict(vit or {}, depth=1)),
                         decoder=DecoderConfig(depth=1), dtype=torch.bfloat16,
                         **impls)
    else:
        m = pretrain_config(model, dtype=torch.bfloat16, **impls)
        m = replace(m, vit=replace(m.vit, depth=1),
                    decoder=replace(m.decoder, depth=1))
    return PretrainConfig(model=m, batch_size=2)


def _depth1_batch(gen):
    return (torch.randn((2, 1024, 128), generator=gen, device="cuda"),
            torch.randn((2, 3, 224, 224), generator=gen, device="cuda"))


def _depth1_step(gen, vit=None, model=None, **impls):
    """One step of ``_depth1_config``: the launch counts. The step makes 9
    attention and 9 MLP calls: two contrastive chunks x 2 modalities, then
    1 + 1 + 2 + 1 (one decoder), and 16 LayerNormFP32 calls under 'lnfres'
    (9 norm1s, 4 + 2 final norms, the decoder's)."""
    from avsiam_tpu_torch.train.pretrain import init_state, make_pretrain_step
    cfg = _depth1_config(vit, model, **impls)
    state = init_state(cfg, gen)
    a, v = _depth1_batch(gen)
    kernels.reset_launches()
    state, metrics = make_pretrain_step(cfg)(state, (a, v), gen, 1e-4)
    assert all(math.isfinite(float(x)) for x in metrics.values()), metrics
    return dict(kernels.LAUNCHES)


def test_two_pass_step_on_the_card(gen):
    """The default impls: every kernel of the 'lnfres' path launched as
    often as the step's attention and MLP calls."""
    launches = _depth1_step(gen)
    assert launches == dict(_NO_LAUNCHES, attention_fwd=9, attention_bwd=9,
                            ln_mlp_fwd=9)


def test_fused_step_on_the_card(gen):
    """``mlp_impl='fused'`` everywhere: K4 and K7 once per MLP call (K7
    running K9 twice), K3 never."""
    launches = _depth1_step(gen, mlp_impl="fused")
    assert launches == dict(_NO_LAUNCHES, attention_fwd=9, attention_bwd=9,
                            mlp_fwd=9, mlp_bwd=9, mlp_dw=18)


def test_vit_h_shaped_step_on_the_card(gen):
    """ViT-H widths (dim 1280, 16 heads of 80) under ``attn_impl='pallas'``
    and ``mlp_impl='dense'``: the head-major K5/K6 at every encoder
    attention call, K1/K2 only in the decoder (D=32), no MLP kernel."""
    launches = _depth1_step(gen, vit=dict(dim=1280, num_heads=16),
                            attn_impl="pallas", mlp_impl="dense")
    assert launches == dict(_NO_LAUNCHES, attention_fwd=1, attention_bwd=1,
                            attention_hm_fwd=8, attention_hm_bwd=8)


@pytest.mark.parametrize("model,attention", [
    ("cav-mae-large", 9), ("cav-mae-huge", 1)], ids=["vit_l", "vit_h"])
def test_wide_variants_step_under_auto(gen, model, attention):
    """ViT-L (dim 1024, 16 heads of 64) and ViT-H (dim 1280, 16 heads of 80)
    in the default impls, 'auto' for attention and the MLP: the MLP kernels
    take their widths, so every block, the decoder's (dim 512) too, folds
    its LN into K3 (``mlp_route``), as the JAX accelerator branch does.
    ViT-L's attention (D=64) is K1/K2 at every call; ViT-H's (D=80) is the
    XLA form, K1/K2 only in the decoder."""
    launches = _depth1_step(gen, model=model)
    assert launches == dict(_NO_LAUNCHES, attention_fwd=attention,
                            attention_bwd=attention, ln_mlp_fwd=9)


# each MLP impl's launches over the 9 MLP calls of a depth-1 step
_WIDE_MLP_LAUNCHES = {
    "lnfres": dict(ln_mlp_fwd=9),
    "fused": dict(mlp_fwd=9, mlp_bwd=9, mlp_dw=18),
    "fres": dict(mlp_fwd=9),
    "fbwd-split": dict(mlp_bwd_dx=9, mlp_dw=18),
    "auto": dict(ln_mlp_fwd=9),
}


@pytest.mark.parametrize("impl", list(_WIDE_MLP_LAUNCHES))
@pytest.mark.parametrize("model,attention", [
    ("cav-mae-large", 9), ("cav-mae-huge", 1)], ids=["vit_l", "vit_h"])
def test_wide_variants_step_under_every_mlp_kernel(gen, monkeypatch, model,
                                                   attention, impl):
    """Depth-1 ViT-L and ViT-H steps (encoder D 1024 and 1280, decoder 512)
    under each MLP kernel impl, 'fbwd' with ``AVSIAM_MLP_BWD=split``: every
    MLP call launches its kernels at these widths, exactly as often as the
    step's 9 MLP calls imply, and the step's metrics are finite."""
    if impl == "fbwd-split":
        monkeypatch.setenv("AVSIAM_MLP_BWD", "split")
    launches = _depth1_step(gen, model=model, mlp_impl=impl.split("-")[0])
    assert launches == dict(_NO_LAUNCHES, attention_fwd=attention,
                            attention_bwd=attention,
                            **_WIDE_MLP_LAUNCHES[impl])


# the launches of a depth-1 'lnfres' step in each contrastive form and
# under remat: two chunks of one clip, so pass 1 makes 4 block calls
# ('exact', 'bucketed'; 'tconcat' one MLP call a modality, 'packed' one
# K4 call over both), 'padded' 2 at full length; pass 2 makes 5 (two
# encoder blocks, mm_layer_1/2, the decoder). Under remat the 6 trunk-block
# calls launch K1 and K3 once more, in the backward.
_FORM_LAUNCHES = {
    "tconcat": dict(attention_fwd=9, attention_bwd=9, ln_mlp_fwd=7),
    "bucketed": dict(attention_fwd=9, attention_bwd=9, ln_mlp_fwd=9),
    "packed": dict(attention_fwd=9, attention_bwd=9, ln_mlp_fwd=5,
                   mlp_fwd=1),
    "padded": dict(attention_fwd=7, attention_bwd=7, ln_mlp_fwd=7),
    "remat": dict(attention_fwd=15, attention_bwd=9, ln_mlp_fwd=15),
}


def _form_impls(form):
    return (dict(remat_blocks=True) if form == "remat"
            else dict(mmixed_impl=form))


@pytest.mark.parametrize("form", list(_FORM_LAUNCHES))
def test_contrastive_forms_step_on_the_card(gen, form):
    """A depth-1 step in each contrastive form and under ``remat_blocks``:
    finite metrics and each kernel launched exactly as often as the form's
    calls imply, remat's recompute included."""
    launches = _depth1_step(gen, **_form_impls(form))
    assert launches == dict(_NO_LAUNCHES, **_FORM_LAUNCHES[form])


@pytest.mark.parametrize("N", [512, 196])
def test_masked_attention_at_the_padded_shapes(gen, N):
    """K1/K2 at 'padded''s encoder shapes (B, 512) and (B, 196), 12 heads of
    64, under the keep masks 'padded' draws: against the plain version, and
    the same bits over 100 calls."""
    from avsiam_tpu_torch.configs import CAVMAEConfig
    from avsiam_tpu_torch.models.cavmae import draw_masks, padded_keep_masks
    B, H, D = 16, 12, 64
    cfg = CAVMAEConfig(mmixed_impl="padded")
    keep = padded_keep_masks(cfg, draw_masks(cfg, B, gen, "cuda",
                                             mae=False))
    kv = keep[0] if N == 512 else keep[1]
    assert kv.shape == (B, N) and int(kv.sum(1).min()) >= int(N * 0.2)
    x = torch.randn((B, N, 3 * H * D), generator=gen, device="cuda"
                    ).bfloat16()
    do = torch.randn((B, N, H * D), generator=gen, device="cuda").bfloat16()

    def call():
        out, stats = pat.attention_fwd_kernel(x, H, kv)
        return out, stats, pat.attention_bwd_kernel(x, out, stats, do, H, kv)

    first = call()
    xr = x.float().requires_grad_(True)
    ref = pat.attention_reference(xr, H, kv)
    (gref,) = torch.autograd.grad(ref, xr, do.float())
    assert _rel(first[0], ref) <= TOL and _rel(first[2], gref) <= TOL
    for _ in range(100):
        assert all(torch.equal(a, b) for a, b in zip(call(), first))


def test_ln_pallas_step_on_the_card(gen, monkeypatch):
    """Under ``AVSIAM_LN=pallas`` K10 runs at every LayerNormFP32 call, and
    the 'lnfres' kernels as without it."""
    monkeypatch.setenv("AVSIAM_LN", "pallas")
    launches = _depth1_step(gen)
    assert launches == dict(_NO_LAUNCHES, attention_fwd=9, attention_bwd=9,
                            ln_mlp_fwd=9, ln_bwd=16)


# the step's routes as one CUDA graph: (impls, environment)
_GRAPH_ROUTES = {
    "lnfres": ({}, {}),
    "fused": (dict(mlp_impl="fused"), {}),
    "fbwd_fres_split": (dict(mlp_impl="fbwd", dec_mlp_impl="fres"),
                        {"AVSIAM_MLP_BWD": "split"}),
    "ln_pallas": ({}, {"AVSIAM_LN": "pallas"}),
    "vit_h_pallas": (dict(vit=dict(dim=1280, num_heads=16),
                          attn_impl="pallas", mlp_impl="fused"), {}),
    **{form: (_form_impls(form), {}) for form in _FORM_LAUNCHES},
}


# fragments of the port's kernel names (``csrc/*.cu``)
_PORT_KERNELS = ("attn_", "ln_bwd_", "ln_mlp_", "mlp_", "colsum_fold")


def _port_kernel_calls(fn):
    """Run ``fn`` under torch.profiler: {kernel name: calls} of the port's
    kernels on the card."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and any(k in e.key for k in _PORT_KERNELS)}


@pytest.mark.parametrize("route", list(_GRAPH_ROUTES))
def test_graphed_step_matches_the_eager_step(gen, monkeypatch, route):
    """Depth-1 steps as one CUDA graph (warm-up, capture, two replays)
    against the eager step from the same seed, the learning rate halved
    each step, in each route, each contrastive form and under remat:
    metrics per step and final parameters the same bits, each graphed call
    counting the launches
    the eager step counts, the last replay, profiled, calling each kernel
    of the port as often as the eager step does, and a batch of another
    shape refused."""
    from avsiam_tpu_torch.train.pretrain import (init_state,
                                                 make_graphed_pretrain_step,
                                                 make_pretrain_step)
    impls, env = _GRAPH_ROUTES[route]
    for k, val in env.items():
        monkeypatch.setenv(k, val)
    cfg = _depth1_config(**impls)
    runs = []
    for graphed in (False, True):
        g = torch.Generator(device="cuda").manual_seed(1)
        state = init_state(cfg, g)
        batch = _depth1_batch(g)
        step = (make_graphed_pretrain_step(cfg) if graphed
                else make_pretrain_step(cfg))
        metrics, launches = [], []
        for i in range(3):
            kernels.reset_launches()
            state, m = step(state, batch, g, 1e-4 * 0.5 ** i)
            torch.cuda.synchronize()
            metrics.append(m)
            launches.append(dict(kernels.LAUNCHES))
        out = {}
        calls = _port_kernel_calls(lambda: out.update(
            m=step(state, batch, g, 1e-4 * 0.5 ** 3)[1]))
        metrics.append(out["m"])
        runs.append((state, metrics, launches, calls))
    (se, me, le, ce), (sg, mg, lg, cg) = runs
    assert lg == le and sum(le[0].values()) > 0
    assert cg == ce and sum(ce.values()) > 0
    for e, g_ in zip(me, mg):
        for k in e:
            assert math.isfinite(float(g_[k]))
            assert torch.equal(g_[k], e[k]), k
    for (name, pe), pg in zip(se.model.named_parameters(),
                              sg.model.parameters()):
        assert torch.equal(pg, pe), name
    a, v = batch
    with pytest.raises(ValueError, match="captured for"):
        step(sg, (a[:1], v[:1]), g, 1e-4)
    with pytest.raises(ValueError, match="captured for"):
        step(sg, (a.bfloat16(), v), g, 1e-4)


def test_graphed_step_replays_keep_their_metrics(gen):
    """Metrics come back as clones: step n's stay as they were after step
    n + 1 replays into the same graph."""
    from avsiam_tpu_torch.train.pretrain import (init_state,
                                                 make_graphed_pretrain_step)
    cfg = _depth1_config()
    state = init_state(cfg, gen)
    batch = _depth1_batch(gen)
    step = make_graphed_pretrain_step(cfg)
    kept = []
    for _ in range(4):
        state, m = step(state, batch, gen, 1e-4)
        kept.append((m, {k: t.clone() for k, t in m.items()}))
    torch.cuda.synchronize()
    for m, copy in kept:
        assert all(torch.equal(m[k], copy[k]) for k in m)
    assert kept[-1][0]["loss"] is not kept[-2][0]["loss"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("R,C", [(5664, 512), (37, 768), (1416, 1280),
                                 (1, 1280), (300, 128)])
def test_ln_bwd_kernel_matches_plain_version(gen, R, C, dtype):
    x = torch.randn((R, C), generator=gen, device="cuda").to(dtype)
    dy = torch.randn((R, C), generator=gen, device="cuda").to(dtype)
    scale = 1.0 + 0.1 * torch.randn(C, generator=gen, device="cuda")
    got = pln.ln_bwd_kernel(x, dy, scale, 1e-5)
    want = pln.ln_bwd_reference(x.float(), dy.float(), scale, 1e-5)
    assert got[0].dtype == dtype
    assert got[1].dtype == got[2].dtype == torch.float32
    for name, g, w in zip(("dx", "dgamma", "dbeta"), got, want):
        assert _rel(g, w) <= TOL, name
    again = pln.ln_bwd_kernel(x, dy, scale, 1e-5)  # no atomics: bit for bit
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("C", [512, 768, 1280])
@pytest.mark.parametrize("R", [1, 7, 33, 5664])
def test_ln_bwd_kernel_at_ragged_rows(gen, R, C, dtype):
    """K10 at row counts that leave its warps and blocks partly filled (1,
    7, 33) and at the decoder's 5664 (two rows a warp on 132 SMs), against
    its plain version in float32 on the same values."""
    x = (0.5 + torch.randn((R, C), generator=gen, device="cuda")).to(dtype)
    dy = torch.randn((R, C), generator=gen, device="cuda").to(dtype)
    scale = 1.0 + 0.1 * torch.randn(C, generator=gen, device="cuda")
    kernels.reset_launches()
    got = pln.ln_bwd_kernel(x, dy, scale, 1e-5)
    assert kernels.LAUNCHES["ln_bwd"] == 1
    want = pln.ln_bwd_reference(x.float(), dy.float(), scale, 1e-5)
    for name, g, w in zip(("dx", "dgamma", "dbeta"), got, want):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, w) <= TOL, name


@pytest.mark.parametrize("R,C", [(5664, 512), (1416, 768), (98, 768)])
def test_ln_bwd_kernel_gives_the_same_bits_every_call(gen, R, C):
    """K10 called 100 times on the same bf16 rows gives bit-identical dx,
    dgamma and dbeta: every sum runs in an order fixed by R and C, with no
    atomics."""
    x = torch.randn((R, C), generator=gen, device="cuda").bfloat16()
    dy = torch.randn((R, C), generator=gen, device="cuda").bfloat16()
    scale = 1.0 + 0.1 * torch.randn(C, generator=gen, device="cuda")
    first = pln.ln_bwd_kernel(x, dy, scale, 1e-5)
    for _ in range(100):
        again = pln.ln_bwd_kernel(x, dy, scale, 1e-5)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


def test_layer_norm_module_launches_k10(gen, monkeypatch):
    """``LayerNormFP32`` under ``AVSIAM_LN=pallas`` runs its backward on
    K10, within the tolerance of the float32 autograd of the plain
    forward; without the flag it launches nothing."""
    from avsiam_tpu_torch.models.layers import LayerNormFP32
    mod = LayerNormFP32(768, 1e-5, torch.bfloat16, "cuda")
    with torch.no_grad():
        mod.weight.add_(0.1 * torch.randn(768, generator=gen, device="cuda"))
    x = torch.randn((2, 177, 768), generator=gen, device="cuda")
    ct = torch.randn((2, 177, 768), generator=gen, device="cuda")
    grads = {}
    for flag in ("pallas", None):
        if flag:
            monkeypatch.setenv("AVSIAM_LN", flag)
        else:
            monkeypatch.delenv("AVSIAM_LN")
        mod.zero_grad(set_to_none=True)
        kernels.reset_launches()
        xt = x.bfloat16().requires_grad_(True)
        mod(xt).backward(ct.bfloat16())
        assert kernels.LAUNCHES["ln_bwd"] == (1 if flag else 0)
        grads[flag] = [xt.grad, mod.weight.grad, mod.bias.grad]
    for got, want in zip(grads["pallas"], grads[None]):
        assert _rel(got, want) <= TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("B,N,H,D,masked", [
    (2, 512, 16, 80, False), (2, 177, 16, 80, True), (8, 49, 16, 80, False),
    (2, 130, 12, 64, True), (3, 37, 16, 32, False), (2, 1, 16, 80, False),
    (2, 15, 16, 80, True), (2, 65, 16, 80, False)])
def test_attention_hm_kernels_match_plain_versions(gen, dtype, B, N, H, D,
                                                   masked):
    """K5 and K6 on the three slices of a packed qkv, through
    ``attention_qkv(impl='pallas')`` where it routes there, against the
    plain versions in float32 on the same values: K5's output and saved
    statistics, K6's gradients against both plain forms (the JAX form that
    recomputes the softmax, and the saved-statistics form the kernels
    take)."""
    x = torch.randn((B, N, 3 * H * D), generator=gen, device="cuda").to(dtype)
    do = torch.randn((B, N, H, D), generator=gen, device="cuda").to(dtype)
    kv = None
    if masked:
        kv = torch.rand((B, N), generator=gen, device="cuda") > 0.3
        kv[:, 0] = True
    q, k, v = x.view(B, N, 3, H, D).unbind(2)
    kernels.reset_launches()
    out, stats = pat.attention_hm_fwd_kernel(q, k, v, kv)
    grads = pat.attention_hm_bwd_kernel(q, k, v, out, stats, do, kv)
    assert (kernels.LAUNCHES["attention_hm_fwd"],
            kernels.LAUNCHES["attention_hm_bwd"]) == (1, 1)
    f = [t.float() for t in (q, k, v)]
    assert out.dtype == dtype and stats.dtype == torch.float32
    assert _rel(out, pat.attention_hm_reference(*f, kv)) <= TOL
    want = pat.attention_hm_stats_reference(f[0], f[1], kv)
    for i, name in enumerate(("max", "1/denominator")):
        # each column against its own scale: the max is far larger
        assert _rel(stats[..., i], want[..., i]) <= TOL, name
    for form in (pat.attention_hm_bwd_reference(*f, do.float(), kv),
                 pat.attention_hm_bwd_stats_reference(
                     *f, out.float(), stats, do.float(), kv)):
        for name, g, w in zip("qkv", grads, form):
            assert g.dtype == dtype
            # one key (N = 1): the softmax has no gradient, so dq and dk
            # are 0 up to rounding, held against dv's scale
            assert _rel(g, w, w if N > 1 else form[2]) <= TOL, f"d{name}"
    if pat.attention_route("pallas", H * D, H) == "head_major":
        xk = x.clone().requires_grad_(True)
        out2 = pat.attention_qkv(xk, H, kv, impl="pallas")
        out2.backward(do.reshape(B, N, H * D))
        assert torch.equal(out2, out.reshape(B, N, H * D))
        assert torch.equal(xk.grad, torch.stack(grads, 2).reshape(x.shape))


@pytest.mark.parametrize("route,B,N,H,D", [
    ("head_major", 2, 512, 16, 80), ("head_major", 2, 512, 12, 64),
    ("token_major", 2, 512, 12, 64), ("token_major", 2, 708, 16, 32)])
def test_attention_kernels_give_the_same_bits_every_call(gen, route, B, N, H,
                                                         D):
    """K5/K6 (head-major) and K1/K2 (token-major), called 100 times on the
    same bf16 inputs, give bit-identical outputs: a race between warps over
    shared memory would show as a call that differs."""
    x = torch.randn((B, N, 3 * H * D), generator=gen, device="cuda"
                    ).bfloat16()
    do = torch.randn((B, N, H * D), generator=gen, device="cuda").bfloat16()
    if route == "head_major":
        q, k, v = x.view(B, N, 3, H, D).unbind(2)
        do = do.view(B, N, H, D)

        def call():
            out, stats = pat.attention_hm_fwd_kernel(q, k, v)
            return (out, stats,
                    *pat.attention_hm_bwd_kernel(q, k, v, out, stats, do))
    else:
        def call():
            out, stats = pat.attention_fwd_kernel(x, H)
            return out, pat.attention_bwd_kernel(x, out, stats, do, H)
    first = call()
    for _ in range(100):
        assert all(torch.equal(a, b) for a, b in zip(call(), first))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("route,N,H,D", [
    ("token_major", 130, 12, 64), ("token_major", 77, 16, 32),
    ("head_major", 130, 16, 80)])
def test_all_masked_sample_attends_to_every_key(gen, dtype, route, N, H, D):
    """A sample whose keys are all masked (K1/K2, K5/K6): every key has bias
    -1e30, so each row's softmax is uniform and its output the mean of v
    over the N keys; the saved max is exactly -1e30 (the contract both
    backwards read: anything else raises exp of a residue of order 1e23)
    and 1/denom 1/N. The gradients are finite and within the tolerance of
    the plain versions, the other sample's (partly masked) too."""
    x = torch.randn((2, N, 3 * H * D), generator=gen, device="cuda").to(dtype)
    do = torch.randn((2, N, H * D), generator=gen, device="cuda").to(dtype)
    kv = torch.rand((2, N), generator=gen, device="cuda") > 0.3
    kv[0, 0] = True
    kv[1, :] = False
    q, k, v = x.view(2, N, 3, H, D).unbind(2)
    f = [t.float() for t in (q, k, v)]
    if route == "token_major":
        out, stats = pat.attention_fwd_kernel(x, H, kv)
        dx = pat.attention_bwd_kernel(x, out, stats, do, H, kv)
        out = out.view(2, N, H, D)
        grads = dx.view(2, N, 3, H, D).unbind(2)
        xr = x.float().requires_grad_(True)
        ref = pat.attention_reference(xr, H, kv)
        (gref,) = torch.autograd.grad(ref, xr, do.float())
        forms = [gref.view(2, N, 3, H, D).unbind(2)]
    else:
        out, stats = pat.attention_hm_fwd_kernel(q, k, v, kv)
        grads = pat.attention_hm_bwd_kernel(q, k, v, out, stats,
                                            do.view(2, N, H, D), kv)
        ref = pat.attention_hm_reference(*f, kv)
        forms = [pat.attention_hm_bwd_reference(*f, do.float().view(
            2, N, H, D), kv), pat.attention_hm_bwd_stats_reference(
            *f, out.float(), stats, do.float().view(2, N, H, D), kv)]
    torch.cuda.synchronize()
    mean = v[1].bfloat16().float().mean(dim=0)  # the kernels' bf16 operands
    assert _rel(out[1], mean.expand(N, H, D)) <= (
        4e-3 if dtype == torch.bfloat16 else 1e-5)
    assert _rel(out, ref.view(2, N, H, D)) <= TOL
    assert bool((stats[1, ..., 0] == -1e30).all())
    inv_n = torch.ones((), device="cuda") / N
    torch.testing.assert_close(stats[1, ..., 1], inv_n.expand(H, N),
                               rtol=1e-6, atol=0)
    for form in forms:
        for name, g, w in zip("qkv", grads, form):
            assert bool(torch.isfinite(g).all()), f"d{name}"
            assert _rel(g, w) <= TOL, f"d{name}"


def test_k5_matches_k1_at_d64(gen):
    """Where both kernels take the shape, K5 and K1 give the same output and
    statistics bit for bit: they run the same forward body, from different
    layouts."""
    x = torch.randn((2, 196, 3 * 768), generator=gen, device="cuda"
                    ).bfloat16()
    kv = torch.rand((2, 196), generator=gen, device="cuda") > 0.2
    kv[:, 0] = True
    q, k, v = x.view(2, 196, 3, 12, 64).unbind(2)
    k5, s5 = pat.attention_hm_fwd_kernel(q, k, v, kv)
    k1, s1 = pat.attention_fwd_kernel(x, 12, kv)
    assert torch.equal(k5.reshape(2, 196, 768), k1)
    assert torch.equal(s5, s1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("B,N,H,D,masked", [
    (2, 196, 12, 64, True), (2, 512, 12, 64, False), (2, 708, 16, 32, True),
    (3, 77, 16, 32, False)])
def test_k2_matches_k6(gen, dtype, B, N, H, D, masked):
    """K2 and K6 run the same backward bodies, from the packed [B, N, 3C]
    qkv and from its head-major views: on the same q, k, v, output, its
    cotangent and statistics, K2's dqkv slices equal K6's dq, dk and dv bit
    for bit."""
    x = torch.randn((B, N, 3 * H * D), generator=gen, device="cuda").to(dtype)
    do = torch.randn((B, N, H * D), generator=gen, device="cuda").to(dtype)
    kv = None
    if masked:
        kv = torch.rand((B, N), generator=gen, device="cuda") > 0.2
        kv[:, 0] = True
    out, stats = pat.attention_fwd_kernel(x, H, kv)
    dqkv = pat.attention_bwd_kernel(x, out, stats, do, H, kv)
    q, k, v = x.view(B, N, 3, H, D).unbind(2)
    grads = pat.attention_hm_bwd_kernel(q, k, v, out.view(B, N, H, D), stats,
                                        do.view(B, N, H, D), kv)
    for name, g2, g6 in zip("qkv", dqkv.view(B, N, 3, H, D).unbind(2),
                            grads):
        assert torch.equal(g2, g6), f"d{name}"


def test_saved_hidden_backward_keeps_dh_in_float32(gen):
    """The 'fres'/'lnfres' backward's dh = do @ w2 is a float32 product of
    the bf16 operands on the card, equal to the float32 product of their
    values up to the order of the sum."""
    do = torch.randn((300, 768), generator=gen, device="cuda").bfloat16()
    w2 = (0.02 * torch.randn((768, 3072), generator=gen, device="cuda")
          ).bfloat16()
    dh = pmlp.mm_f32(do, w2)
    assert dh.dtype == torch.float32
    want = do.float() @ w2.float()
    assert float((dh - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert not torch.equal(dh, (do @ w2).float())  # not the bf16 product


def _mlp_operands(gen, T, Dm, dtype):
    Hm = 4 * Dm

    def r(*shape, k=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * k

    return (r(T, Dm).to(dtype), r(Hm, Dm, k=Dm ** -0.5).bfloat16(),
            r(Hm, k=0.02).bfloat16().float(),
            r(Dm, Hm, k=Hm ** -0.5).bfloat16(),
            r(Dm, k=0.02).bfloat16().float(), r(T, Dm).to(dtype))


MLP_SHAPES = [(1024, 768), (37, 768), (5664, 512)]
# ViT-L's and ViT-H's encoder widths (H = 4 D), at a phase-E row count and
# at one that fills no tile
WIDE_MLP_SHAPES = [(392, 1024), (37, 1024), (1416, 1280), (130, 1280)]


@pytest.mark.parametrize("save_hpre", [False, True], ids=["out", "hpre"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("T,Dm", MLP_SHAPES)
def test_mlp_fwd_kernel_matches_plain_version(gen, T, Dm, dtype, save_hpre):
    x, w1, b1, w2, b2, _ = _mlp_operands(gen, T, Dm, dtype)
    got = pmlp.mlp_fwd_kernel(x, w1, b1, w2, b2, save_hpre)
    want = pmlp.mlp_fwd_reference(x.float(), w1.float(), b1, w2.float(), b2,
                                  save_hpre=save_hpre)
    got, want = (got, want) if save_hpre else ((got,), (want,))
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert _rel(g, w) <= TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("T,Dm", MLP_SHAPES)
def test_mlp_bwd_kernels_match_plain_versions(gen, T, Dm, dtype):
    """K7's five outputs, K8's dx, gh and act, and K9 on (x, gh) and
    (act, do), each against its plain version on the same values."""
    x, w1, b1, w2, _, do = _mlp_operands(gen, T, Dm, dtype)
    f = lambda t: t.float()  # noqa: E731
    got7 = pmlp.mlp_bwd_kernel(x, w1, b1, w2, do)
    want7 = pmlp.mlp_bwd_reference(f(x), f(w1), b1, f(w2), f(do))
    assert got7[0].dtype == dtype
    assert all(g.dtype == torch.float32 for g in got7[1:])
    for name, g, w in zip(("dx", "dw1", "db1", "dw2", "db2"), got7, want7):
        assert _rel(g, w) <= TOL, name
    got8 = pmlp.mlp_bwd_dx_kernel(x, w1, b1, w2, do)
    want8 = pmlp.mlp_bwd_dx_reference(f(x), f(w1), b1, f(w2), f(do))
    for name, g, w in zip(("dx", "gh", "act"), got8, want8):
        assert g.dtype == dtype
        assert _rel(g, w) <= TOL, name
    _, gh, act = got8
    for a, g in ((x, gh), (act, do)):
        dw, db = pmlp.weight_grads_kernel(a, g)
        wdw, wdb = pmlp.weight_grads_reference(f(a), f(g))
        assert _rel(dw, wdw) <= TOL and _rel(db, wdb) <= TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("T,Dm", WIDE_MLP_SHAPES)
def test_mlp_kernels_at_wide_widths(gen, T, Dm, dtype):
    """K3, K4 (with the hidden), K7 and K8 at D 1024 and 1280, each against
    its plain version on the same values; each launched once."""
    x, w1, b1, w2, b2, do = _mlp_operands(gen, T, Dm, dtype)
    f = lambda t: t.float()  # noqa: E731
    lg = 1.0 + 0.1 * torch.randn(Dm, generator=gen, device="cuda")
    lb = 0.1 * torch.randn(Dm, generator=gen, device="cuda")
    kernels.reset_launches()
    pairs = [
        (pmlp.ln_mlp_fwd_kernel(x, lg, lb, w1, b1, w2, b2, 1e-5),
         pmlp.ln_mlp_reference(f(x), lg, lb, f(w1), b1, f(w2), b2, 1e-5)),
        (pmlp.mlp_fwd_kernel(x, w1, b1, w2, b2, True),
         pmlp.mlp_fwd_reference(f(x), f(w1), b1, f(w2), b2, save_hpre=True)),
        (pmlp.mlp_bwd_kernel(x, w1, b1, w2, do),
         pmlp.mlp_bwd_reference(f(x), f(w1), b1, f(w2), f(do))),
        (pmlp.mlp_bwd_dx_kernel(x, w1, b1, w2, do),
         pmlp.mlp_bwd_dx_reference(f(x), f(w1), b1, f(w2), f(do)))]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == dict(_NO_LAUNCHES, ln_mlp_fwd=1, mlp_fwd=1,
                                    mlp_bwd=1, mlp_bwd_dx=1, mlp_dw=2)
    for i, (got, want) in enumerate(pairs):
        for j, (g, w) in enumerate(zip(got, want)):
            assert bool(torch.isfinite(g).all()), (i, j)
            assert _rel(g, w) <= TOL, (i, j)


def test_mlp_partial_forms_at_half_hidden_widths(gen):
    """Tensor parallelism over two ranks: at ViT-H's and ViT-B's half
    hidden widths (D 1280, H 2560; D 768, H 1536), K3's and K4's fc2 pass
    write the float32 partial product act w2^T with no b2 and no residual
    (K4 with the hidden too), and K7's dx pass the float32 partial dx,
    each against its plain version on the same values, in bf16 storage;
    each launched once a call."""
    f = lambda t: t.float()  # noqa: E731
    for T, Dm, Hm in ((1416, 1280, 2560), (130, 1280, 2560),
                      (1024, 768, 1536), (37, 768, 1536)):
        x = torch.randn((T, Dm), generator=gen, device="cuda").bfloat16()
        do = torch.randn((T, Dm), generator=gen, device="cuda").bfloat16()
        w1 = (torch.randn((Hm, Dm), generator=gen, device="cuda")
              * Dm ** -0.5).bfloat16()
        b1 = (torch.randn(Hm, generator=gen, device="cuda") * 0.02
              ).bfloat16().float()
        w2 = (torch.randn((Dm, Hm), generator=gen, device="cuda")
              * Hm ** -0.5).bfloat16()
        lg = 1.0 + 0.1 * torch.randn(Dm, generator=gen, device="cuda")
        lb = 0.1 * torch.randn(Dm, generator=gen, device="cuda")
        kernels.reset_launches()
        pairs = [
            (pmlp.ln_mlp_fwd_kernel(x, lg, lb, w1, b1, w2, None, 1e-5,
                                    partial=True),
             pmlp.ln_mlp_reference(f(x), lg, lb, f(w1), b1, f(w2), None,
                                   1e-5, partial=True)),
            (pmlp.mlp_fwd_kernel(x, w1, b1, w2, None, True),
             pmlp.mlp_fwd_reference(f(x), f(w1), b1, f(w2), None,
                                    save_hpre=True)),
            (pmlp.mlp_bwd_kernel(x, w1, b1, w2, do, dx_dtype=torch.float32),
             pmlp.mlp_bwd_reference(f(x), f(w1), b1, f(w2), f(do),
                                    dx_dtype=torch.float32))]
        torch.cuda.synchronize()
        assert kernels.LAUNCHES == dict(_NO_LAUNCHES, ln_mlp_fwd=1,
                                        mlp_fwd=1, mlp_bwd=1, mlp_dw=2)
        for i, (got, want) in enumerate(pairs):
            assert got[0].dtype == torch.float32, (T, Dm, i)  # the partial
            for j, (g, w) in enumerate(zip(got, want)):
                assert bool(torch.isfinite(g).all()), (T, Dm, i, j)
                assert _rel(g, w) <= TOL, (T, Dm, i, j)


@pytest.mark.parametrize("T,Dm", [(1416, 768), (156, 768), (392, 1280),
                                  (5664, 512)])
def test_mlp_backward_passes_give_the_same_bits_every_call(gen, T, Dm):
    """K8 (the gh and dx passes) and K7 (with K7's db1 fold), called 100
    times on the same bf16 inputs, give bit-identical outputs: every output
    element has one owner that sums in a fixed order, the dx pass's split
    partials too."""
    x, w1, b1, w2, _, do = _mlp_operands(gen, T, Dm, torch.bfloat16)

    def call():
        return (*pmlp.mlp_bwd_dx_kernel(x, w1, b1, w2, do),
                *pmlp.mlp_bwd_kernel(x, w1, b1, w2, do))
    first = call()
    for _ in range(100):
        assert all(torch.equal(a, b) for a, b in zip(call(), first))


@pytest.mark.parametrize("T,Dm", [(156, 768), (1416, 1280)])
def test_mlp_forward_kernels_give_the_same_bits_every_call(gen, T, Dm):
    """K3 and K4 (with and without the hidden), called 100 times on the
    same bf16 inputs, give bit-identical outputs: every output element has
    one owner that sums in a fixed order, the fc2 pass's split partials too
    (at (156, 768) the fc2 pass splits H)."""
    x, w1, b1, w2, b2, _ = _mlp_operands(gen, T, Dm, torch.bfloat16)
    lg = 1.0 + 0.1 * torch.randn(Dm, generator=gen, device="cuda")
    lb = 0.1 * torch.randn(Dm, generator=gen, device="cuda")

    def call():
        return (*pmlp.ln_mlp_fwd_kernel(x, lg, lb, w1, b1, w2, b2, 1e-5),
                pmlp.mlp_fwd_kernel(x, w1, b1, w2, b2),
                *pmlp.mlp_fwd_kernel(x, w1, b1, w2, b2, True))
    first = call()
    for _ in range(100):
        assert all(torch.equal(a, b) for a, b in zip(call(), first))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("T", [37, 3400])
def test_mlp_forward_kernels_at_a_half_hidden_tile(gen, T, dtype):
    """K3 and K4 (with the hidden) at D 256, H 576 (H % 128 == 64: an odd
    count of the fc1 pass's 64-wide hidden tiles and of the fc2 pass's
    slabs of H), and the fc1 pass alone, each against its plain version on
    the same values."""
    Dm, Hm = 256, 576

    def r(*shape, k=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * k

    x = r(T, Dm).to(dtype)
    w1 = r(Hm, Dm, k=Dm ** -0.5).bfloat16()
    w2 = r(Dm, Hm, k=Hm ** -0.5).bfloat16()
    b1, b2 = r(Hm, k=0.02).bfloat16().float(), r(Dm, k=0.02).bfloat16().float()
    lg, lb = 1.0 + r(Dm, k=0.1), r(Dm, k=0.1)
    f = lambda t: t.float()  # noqa: E731
    pairs = [
        (pmlp.ln_mlp_fwd_kernel(x, lg, lb, w1, b1, w2, b2, 1e-5),
         pmlp.ln_mlp_reference(f(x), lg, lb, f(w1), b1, f(w2), b2, 1e-5)),
        (pmlp.mlp_fwd_kernel(x, w1, b1, w2, b2, True),
         pmlp.mlp_fwd_reference(f(x), f(w1), b1, f(w2), b2, save_hpre=True))]
    pairs.append((pmlp._fc1_pass(x.bfloat16(), w1, b1, dtype, True),
                  pmlp.mlp_fc1_reference(f(x.bfloat16()), f(w1), b1)))
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(pairs):
        for j, (g, w) in enumerate(zip(got, want)):
            assert bool(torch.isfinite(g).all()), (i, j)
            assert _rel(g, w) <= TOL, (i, j)


@pytest.mark.parametrize("T,Dm", MLP_SHAPES)
def test_kernels_keep_their_db1_forms(gen, T, Dm):
    """In bfloat16 K7's db1 sums the float32 gh, and the split backward's
    (K9 on K8's stash) the bfloat16 gh. Each kernel lies within a tenth of
    the gap between the two forms of its own form."""
    x, w1, b1, w2, _, do = _mlp_operands(gen, T, Dm, torch.bfloat16)
    f = lambda t: t.float()  # noqa: E731
    own7 = pmlp.mlp_bwd_reference(f(x), f(w1), b1, f(w2), f(do))[2]
    gh8 = pmlp.mlp_bwd_dx_kernel(x, w1, b1, w2, do)[1]
    own9 = gh8.float().sum(dim=0)
    gap = (own7 - own9).abs().max()
    assert gap > 0
    db1_7 = pmlp.mlp_bwd_kernel(x, w1, b1, w2, do)[2]
    db1_9 = pmlp.weight_grads_kernel(x, gh8)[1]
    assert (db1_7 - own7).abs().max() < 0.1 * gap
    assert (db1_9 - own9).abs().max() < 0.1 * gap


def test_av_tail_launches_the_mlp_kernel(gen):
    """Under 'lnfres' the 'av' tail's MLP is K4 (the 'fres' route), not K3."""
    from avsiam_tpu_torch.models.layers import ModalityBlock
    blk = ModalityBlock(768, 12, 4.0, True, 1e-5, torch.bfloat16, "auto",
                        "erf", "lnfres", "cuda")
    x = torch.randn((2, 20, 768), generator=gen, device="cuda")
    kernels.reset_launches()
    a, v = blk((x[:, :8], x[:, 8:]), "av")
    a.float().sum().backward()
    assert kernels.LAUNCHES == dict(_NO_LAUNCHES, attention_fwd=1,
                                    attention_bwd=1, mlp_fwd=1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("Dm", [768, 512])
@pytest.mark.parametrize("T", [37, 156, 1416, 5664])
def test_weight_grads_kernel_matches_plain_version(gen, T, Dm, dtype):
    """K9 on (x [T, D], gh [T, 4D]) and (act [T, 4D], do [T, D]), dw and
    its db form (the bf16 kernel sums the stored bf16 g, the f32 kernel the
    f32 g), against ``weight_grads_reference`` on the same values. In bf16
    on 132 SMs the decoder's widths take the 128 x 128 tiles, ViT-B's the
    192 x 96 (``test_weight_grad_tile_takes_the_fewest_waves``)."""
    Hm = 4 * Dm
    x, h, o = (torch.randn(s, generator=gen, device="cuda").to(dtype)
               for s in ((T, Dm), (T, Hm), (T, Dm)))
    kernels.reset_launches()
    for a, g in ((x, h), (h, o)):
        wdw, wdb = pmlp.weight_grads_reference(a.float(), g.float())
        dw, db = pmlp.weight_grads_kernel(a, g)
        assert dw.dtype == db.dtype == torch.float32
        assert dw.shape == (g.shape[1], a.shape[1])
        assert db.shape == (g.shape[1],)
        # db: one sum of T values in float32 in another order, no products
        assert _rel(dw, wdw) <= TOL and _rel(db, wdb) <= 1e-4
    assert kernels.LAUNCHES["mlp_dw"] == 2


@pytest.mark.parametrize("T", [1416, 156])
def test_weight_grads_kernel_gives_the_same_bits_every_call(gen, T):
    """K9 at a phase-C shape (T, 768, 3072), called 100 times on the same
    bf16 inputs, gives bit-identical dw and db both ways round: every output
    element has one owner summing in a fixed order."""
    x = torch.randn((T, 768), generator=gen, device="cuda").bfloat16()
    h = torch.randn((T, 3072), generator=gen, device="cuda").bfloat16()
    first = (*pmlp.weight_grads_kernel(x, h), *pmlp.weight_grads_kernel(h, x))
    for _ in range(100):
        again = (*pmlp.weight_grads_kernel(x, h),
                 *pmlp.weight_grads_kernel(h, x))
        assert all(torch.equal(a, b) for a, b in zip(again, first))


_CAPTURE_ERROR = """
import math, sys, torch
sys.path.insert(0, {tests!r})
from test_torch_port_cuda import _depth1_batch, _depth1_config
from avsiam_tpu_torch.train import pretrain as ppre
gen = torch.Generator(device="cuda").manual_seed(0)
cfg = _depth1_config()
state = ppre.init_state(cfg, gen)
batch = _depth1_batch(gen)
step = ppre.make_graphed_pretrain_step(cfg)
state, _ = step(state, batch, gen, 1e-4)  # the warm-up, eager
body = ppre.pretrain_step_body


def syncing_body(*args):
    metrics = body(*args)
    float(metrics["loss"])  # a host sync, as a check might make
    return metrics


ppre.pretrain_step_body = syncing_body
before = state.step
for expected in ("capturing the pretrain step", "failed to capture"):
    try:
        step(state, batch, gen, 1e-4)
    except RuntimeError as err:
        assert expected in str(err), err
    else:
        raise AssertionError("no error: " + expected)
assert state.step == before
print("raised twice")
"""


def test_graphed_step_raises_on_a_capture_error(gen):
    """A host sync inside the captured body (a ``float(tensor)``, as a check
    might do) fails the capture: the call raises, and so does every later
    one, without running the step eagerly. In a process of its own, since
    the failed capture is left behind in it."""
    import os
    import subprocess
    import sys
    tests = os.path.dirname(os.path.abspath(__file__))
    run = subprocess.run(
        [sys.executable, "-c", _CAPTURE_ERROR.format(tests=tests)],
        cwd=os.path.dirname(tests), capture_output=True, text=True,
        timeout=600)
    assert run.returncode == 0 and "raised twice" in run.stdout, (
        run.stdout[-2000:] + run.stderr[-4000:])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("gelu", ["ans", "tanh", "cheb", "tanh5"])
def test_mlp_kernels_under_every_gelu_form(gen, gelu, dtype):
    """K3, K4 (with the hidden), K7 and K8 under each GELU form the kernels
    run, against their plain versions in float32 on the same values; in
    float32 storage also the form itself (``_assert_gelu_form``)."""
    T, Dm, Hm = 300, 256, 1024
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x, do = rnd(T, Dm).to(dtype), rnd(T, Dm).to(dtype)
    w1, w2 = rnd(Hm, Dm, scale=Dm ** -0.5).to(bf), rnd(Dm, Hm, scale=Hm ** -0.5).to(bf)
    b1, b2 = rnd(Hm, scale=0.1), rnd(Dm, scale=0.1)
    g, bl = 1.0 + rnd(Dm, scale=0.1), rnd(Dm, scale=0.1)
    xf, w1f, w2f, dof = x.float(), w1.float(), w2.float(), do.float()
    pairs = [
        (pmlp.ln_mlp_fwd_kernel(x, g, bl, w1, b1, w2, b2, 1e-5, gelu=gelu),
         pmlp.ln_mlp_reference(xf, g, bl, w1f, b1, w2f, b2, 1e-5, gelu)),
        (pmlp.mlp_fwd_kernel(x, w1, b1, w2, b2, True, gelu=gelu),
         pmlp.mlp_fwd_reference(xf, w1f, b1, w2f, b2, gelu, True)),
        (pmlp.mlp_bwd_kernel(x, w1, b1, w2, do, gelu=gelu),
         pmlp.mlp_bwd_reference(xf, w1f, b1, w2f, dof, gelu)),
        (pmlp.mlp_bwd_dx_kernel(x, w1, b1, w2, do, gelu=gelu),
         pmlp.mlp_bwd_dx_reference(xf, w1f, b1, w2f, dof, gelu))]
    torch.cuda.synchronize()
    for got, want in pairs:
        for a, b in zip(got, want, strict=True):
            assert _rel(a, b) <= TOL
    if dtype == torch.float32:
        _assert_gelu_form(gelu, x, w1, b1, w2, b2, do)


# Pairs of forms whose float32 values differ by float32 rounding only
# ('cheb' and 'ans' by about 1e-7 RMS in act and gelu'): not told apart.
_GELU_TWINS = ({"ans", "cheb"},)


def _assert_gelu_form(gelu, x, w1, b1, w2, b2, do):
    """The form the kernels run, where bf16 storage cannot show it: K8's
    float32 act and gh against each form's plain act and (do w2) * gelu',
    in float64 from K4's float32 hpre (the same bf16 operands and f32
    accumulation as K8's recomputed hidden). Within 1e-4 of the asked
    form's, and at most half as far from it (RMS) as from any other form
    the values tell apart ('tanh' differs from 'ans' by about 5e-4 in act
    and 9e-4 in gelu', 'tanh5' by about 6e-6 and 2e-5)."""
    from avsiam_tpu_torch.ops import gelu as pgelu
    _, hpre = pmlp.mlp_fwd_kernel(x, w1, b1, w2, b2, True, gelu=gelu)
    _, gh, act = pmlp.mlp_bwd_dx_kernel(x, w1, b1, w2, do, gelu=gelu)
    h64 = hpre.double()
    dw = do.to(torch.bfloat16).double() @ w2.double()

    def plain(form):
        return (pgelu.gelu_f32(h64, form),
                dw * pgelu.gelu_grad_f32(h64, form))

    def rms(a, b):
        return float((a.double() - b).pow(2).mean().sqrt())

    mine = plain(gelu)
    for got, want in zip((act, gh), mine, strict=True):
        assert float((got.double() - want).abs().max()) <= 1e-4
    for other in ("ans", "tanh", "cheb", "tanh5"):
        if other == gelu or {gelu, other} in _GELU_TWINS:
            continue
        for got, want, theirs in zip((act, gh), mine, plain(other),
                                     strict=True):
            assert rms(got, want) <= 0.5 * rms(got, theirs), other


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("C,H", [(128, 128), (128, 64), (128, 32),
                                 (128, 16), (128, 8), (256, 2)],
                         ids=["d1", "d2", "d4", "d8", "d16", "d128"])
def test_attention_kernels_at_every_token_major_width(gen, C, H, masked,
                                                      dtype):
    """K1/K2 at every head width that divides 128 beyond the step's (D 1,
    2, 4, 8, 16 and 128), through ``attention_qkv`` under 'auto' (the JAX
    ``tm_ok`` route), against the plain version in float32."""
    N = 77
    x = torch.randn((2, N, 3 * C), generator=gen, device="cuda").to(dtype)
    ct = torch.randn((2, N, C), generator=gen, device="cuda").to(dtype)
    kv = None
    if masked:
        kv = torch.rand((2, N), generator=gen, device="cuda") > 0.3
        kv[:, 0] = True
    assert pat.attention_route("auto", C, H) == "token_major"
    before = kernels.LAUNCHES["attention_fwd"]
    xk = x.clone().requires_grad_(True)
    out = pat.attention_qkv(xk, H, kv)
    out.backward(ct)
    assert kernels.LAUNCHES["attention_fwd"] == before + 1
    xr = x.float().requires_grad_(True)
    ref = pat.attention_reference(xr, H, kv)
    ref.backward(ct.float())
    assert _rel(out, ref) <= TOL
    assert _rel(xk.grad, xr.grad) <= TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("D", [1, 7, 8, 16, 20, 48, 96, 100, 112, 128, 136,
                               192, 256])
def test_attention_hm_kernels_at_every_width(gen, D, masked, dtype):
    """K5/K6 at head widths from 1 to 256 (16-byte rows and not, every tile
    width, the split dk/dv tiles of the 128 tile, and above 128 the wide
    path's chunks and slices, a part slice at 136 and 192) on the views of a
    packed qkv, against the plain versions in float32; D=0 raises."""
    B, N, H = 2, 91, 3
    x = torch.randn((B, N, 3 * H * D), generator=gen, device="cuda").to(dtype)
    do = torch.randn((B, N, H, D), generator=gen, device="cuda").to(dtype)
    kv = None
    if masked:
        kv = torch.rand((B, N), generator=gen, device="cuda") > 0.3
        kv[:, 0] = True
    q, k, v = x.view(B, N, 3, H, D).unbind(2)
    out, stats = pat.attention_hm_fwd_kernel(q, k, v, kv)
    grads = pat.attention_hm_bwd_kernel(q, k, v, out, stats, do, kv)
    torch.cuda.synchronize()
    f = [t.float() for t in (q, k, v)]
    assert _rel(out, pat.attention_hm_reference(*f, kv)) <= TOL
    for got, want in zip(grads, pat.attention_hm_bwd_reference(
            *f, do.float(), kv), strict=True):
        assert _rel(got, want) <= TOL
    empty = torch.zeros((B, N, H, 0), device="cuda", dtype=dtype)
    with pytest.raises(ValueError, match="non-empty heads"):
        pat.attention_hm_fwd_kernel(empty, empty, empty)


def test_fbank_and_transform_on_the_card(gen):
    """``kaldi_fbank`` on the card against the float64 NumPy version, and
    the train transform (finetune augmentations) on the card against the
    CPU from the same draws: masks exact, values within 5e-3."""
    import numpy as np

    from avsiam_tpu_torch.configs import AudioConfig
    from avsiam_tpu_torch.data.dataset import make_train_transform
    from avsiam_tpu_torch.ops import augment as aug
    from avsiam_tpu_torch.ops.fbank import kaldi_fbank, kaldi_fbank_np
    wav = (np.random.RandomState(0).randn(32000) * 0.1).astype(np.float32)
    got = kaldi_fbank(torch.from_numpy(wav).cuda()).cpu().numpy()
    np.testing.assert_allclose(got, kaldi_fbank_np(wav), atol=5e-3, rtol=5e-4)
    cfg = AudioConfig(num_mel_bins=64, target_length=256, freqm=24, timem=48,
                      mixup=0.5, noise=True)
    B, n = 4, 41600
    w = torch.randn((B, n), generator=gen, device="cuda") * 0.05
    frames = torch.randint(0, 255, (B, 1, 32, 32, 3), generator=gen,
                           device="cuda", dtype=torch.uint8)
    labels = torch.rand((B, 5), generator=gen, device="cuda")
    lens = torch.full((B,), n, dtype=torch.int32, device="cuda")
    draws = aug.draw_transform(cfg, B, gen)
    tr = make_train_transform(cfg, im_res=48)
    out = tr(draws, w, frames, labels, lens)
    ref = tr(aug.TransformDraws(*(d.cpu() for d in draws)), w.cpu(),
             frames.cpu(), labels.cpu(), lens.cpu())
    for a, b in zip(out, ref, strict=True):
        assert float((a.cpu() - b).abs().max()) <= 5e-3


def test_graphed_step_captures_while_another_thread_copies(gen):
    """The capture is thread-local: a thread that pins host tensors and
    copies them to the card on its own stream throughout the warm-up,
    the capture and the replays (as ``device_loader``'s worker does)
    leaves the graph valid and its metrics finite."""
    import threading

    from avsiam_tpu_torch.train.pretrain import (init_state,
                                                 make_graphed_pretrain_step)
    cfg = _depth1_config()
    state = init_state(cfg, gen)
    batch = _depth1_batch(gen)
    step = make_graphed_pretrain_step(cfg)
    stop, copies = threading.Event(), []

    def copier():
        side = torch.cuda.Stream()
        while not stop.is_set():
            host = torch.randn(1 << 20).pin_memory()
            with torch.cuda.stream(side):
                host.to("cuda", non_blocking=True)
            side.synchronize()
            copies.append(1)

    thread = threading.Thread(target=copier, daemon=True)
    thread.start()
    try:
        for _ in range(4):
            state, metrics = step(state, batch, gen, 1e-4)
        torch.cuda.synchronize()
    finally:
        stop.set()
        thread.join(timeout=30)
    assert not thread.is_alive() and len(copies) > 0
    assert all(math.isfinite(float(x)) for x in metrics.values())
    assert step.graph is not None


def _ft_config(dtype=torch.bfloat16, **impls):
    """The finetune model at ViT-B width, depth 2, 309 classes (the
    VGGSound recipe's), batch 2, 'mm_grad'."""
    from avsiam_tpu_torch.configs import (CAVMAEFTConfig, FinetuneConfig,
                                          ViTConfig)
    return FinetuneConfig(
        model=CAVMAEFTConfig(vit=ViTConfig(depth=2), label_dim=309,
                             num_eval_frames=2, dtype=dtype, **impls),
        batch_size=2, loss="CE", ftmode="mm_grad")


@pytest.mark.parametrize("impls,u,per_call", [
    (dict(mlp_impl="fused", attn_impl="pallas"), 0.9,
     dict(mlp_fwd=1, mlp_bwd=1, mlp_dw=2)),
    (dict(mlp_impl="fused", attn_impl="pallas"), 0.1,
     dict(mlp_fwd=1, mlp_bwd=1, mlp_dw=2)),
    (dict(mlp_impl="fused", attn_impl="pallas"), 0.4,
     dict(mlp_fwd=1, mlp_bwd=1, mlp_dw=2)),
    (dict(), 0.9, dict(ln_mlp_fwd=1))],
    ids=["fused-pallas-av", "fused-pallas-a", "fused-pallas-v", "lnfres-av"])
def test_finetune_step_on_the_card(gen, impls, u, per_call):
    """One 'mm_grad' step at depth 2 in bf16 through the kernels against
    the plain versions in float32 on the CPU from the same parameters: the
    loss within 2e-2 relative and the gradients' cosine at least 0.99. The
    forward runs 6 attention and MLP calls (2 audio, 2 video, 2 fusion);
    the backward only the routed branch's: 6 for the fused loss, 2 for the
    audio or the video one."""
    from avsiam_tpu_torch.configs import replace
    from avsiam_tpu_torch.models.cavmae_ft import CAVMAEFinetune
    from avsiam_tpu_torch.train import finetune as ft
    cfg = _ft_config(**impls)
    state = ft.init_state(cfg, gen)
    cpu = CAVMAEFinetune(replace(cfg.model, dtype=torch.float32), "cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in
                         state.model.state_dict().items()})
    a = torch.randn((2, 1024, 128), generator=gen, device="cuda")
    v = torch.randn((2, 1, 3, 224, 224), generator=gen, device="cuda")
    y = torch.softmax(torch.randn((2, 309), generator=gen, device="cuda"),
                      dim=-1)
    kernels.reset_launches()
    state, metrics = ft.make_finetune_step(cfg)(state, (a, v, y), 1e-4, u)
    launches = dict(kernels.LAUNCHES)
    branch = ft.route(u)
    back = 6 if branch == "av" else 2
    want = dict(_NO_LAUNCHES, attention_fwd=6, attention_bwd=back)
    for k, n in per_call.items():
        want[k] = n * (6 if k in ("mlp_fwd", "ln_mlp_fwd") else back)
    assert launches == want
    outs = dict(zip(ft.BRANCHES, cpu(a.cpu(), v.cpu(), "mm_grad")))
    loss = ft.ce_with_soft_targets(outs[branch], y.cpu())
    loss.backward()
    loss = float(loss.detach())
    assert abs(float(metrics["loss"]) - loss) <= 2e-2 * loss
    names = [n for n, p in cpu.named_parameters() if p.grad is not None]
    got = dict(state.model.named_parameters())
    assert names == [n for n, p in got.items() if p.grad is not None]
    g = torch.cat([got[n].grad.double().cpu().flatten() for n in names])
    w = torch.cat([p.grad.double().flatten() for n, p in
                   cpu.named_parameters() if p.grad is not None])
    assert float(torch.nn.functional.cosine_similarity(g, w, dim=0)) >= 0.99


def test_finetune_eval_forward_on_the_card(gen):
    """The 'mm_grad' eval form, the frames folded into the fusion layers'
    batch, within 2e-2 of the plain versions: one K1 and one K3 per block
    call (2 audio, 2 video over B x T frames, 2 fusion)."""
    from avsiam_tpu_torch.configs import replace
    from avsiam_tpu_torch.models.cavmae_ft import CAVMAEFinetune
    from avsiam_tpu_torch.train import finetune as ft
    cfg = _ft_config()
    model = CAVMAEFinetune(cfg.model, "cuda", gen)
    cpu = CAVMAEFinetune(replace(cfg.model, dtype=torch.float32), "cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    a = torch.randn((2, 1024, 128), generator=gen, device="cuda")
    v = torch.randn((2, 2, 3, 224, 224), generator=gen, device="cuda")
    kernels.reset_launches()
    out = ft.make_ft_eval_step(cfg)(model, (a, v, None))
    assert dict(kernels.LAUNCHES) == dict(_NO_LAUNCHES, attention_fwd=6,
                                          ln_mlp_fwd=6)
    with torch.no_grad():
        ref = cpu(a.cpu(), v.cpu(), "mm_grad", True)
    assert out.shape == ref.shape == (2, 2, 309)
    assert _rel(out.cpu(), ref) <= TOL


@pytest.mark.parametrize("tr_pos", [False, True])
def test_audio_only_model_on_the_card(gen, tr_pos):
    """The audio-only model at ViT-B width, depth 2 (one block of each
    kind), B=2, 527 classes: the bf16 kernels on the card against the
    float32 plain model on the CPU from the same parameters, the BCE loss
    within 2e-2 relative and the gradients' cosine at least 0.99; one K1,
    one K3 and one K2 a block; with ``tr_pos`` false no gradient reaches
    the position table, with it true one does."""
    from avsiam_tpu_torch.configs import ViTConfig
    from avsiam_tpu_torch.models import CAVMAEFTAudio
    from avsiam_tpu_torch.train.finetune import bce_with_logits
    vit = ViTConfig(depth=2)
    card = CAVMAEFTAudio(vit, 527, modality_specific_depth=1, tr_pos=tr_pos,
                         dtype=torch.bfloat16, generator=gen)
    cpu = CAVMAEFTAudio(vit, 527, modality_specific_depth=1, tr_pos=tr_pos,
                        device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
    a = torch.randn((2, 1024, 128), generator=gen, device="cuda")
    y = (torch.rand((2, 527), generator=gen, device="cuda") < 0.05).float()
    kernels.reset_launches()
    loss = bce_with_logits(card.forward_pred(a), y)
    loss.backward()
    assert dict(kernels.LAUNCHES) == dict(_NO_LAUNCHES, attention_fwd=2,
                                          ln_mlp_fwd=2, attention_bwd=2)
    ref = bce_with_logits(cpu.forward_pred(a.cpu()), y.cpu())
    ref.backward()
    assert abs(float(loss) - float(ref)) <= 2e-2 * abs(float(ref))
    names = [n for n, p in cpu.named_parameters() if p.grad is not None]
    got = dict(card.named_parameters())
    assert names == [n for n, p in got.items() if p.grad is not None]
    assert ("pos_embed_a" in names) == tr_pos
    g = torch.cat([got[n].grad.double().cpu().flatten() for n in names])
    w = torch.cat([p.grad.double().flatten() for n, p in
                   cpu.named_parameters() if p.grad is not None])
    assert float(torch.nn.functional.cosine_similarity(g, w, dim=0)) >= 0.99


@pytest.mark.parametrize("modality,N,r", [("a", 512, 16), ("v", 196, 64)])
def test_tome_block_on_the_card(gen, modality, N, r):
    """A ViT-B block with r > 0 in bf16 ('auto': K1, then K3 over the
    merged tokens) against the float32 plain block ('xla', 'dense') on the
    card, by pieces, as ``chip_smoke.py``'s phase TOME holds it: the
    attention output and the matching metric within 2e-2; r slots dropped
    a sample by each plan; under the plain plan, the merge and the MLP
    residual within 2e-2 over the kept slots, and the token mass kept;
    the whole block's call drops r slots a sample; 2 K1 and 2 K3."""
    from avsiam_tpu_torch.models.layers import ModalityBlock
    from avsiam_tpu_torch.models.tome import (bipartite_soft_matching,
                                              merge_wavg)

    def block(dtype, attn, mlp):
        return ModalityBlock(768, 12, 4.0, True, 1e-5, dtype, attn, "erf",
                             mlp, "cuda")

    blk = block(torch.bfloat16, "auto", "auto")
    with torch.no_grad():
        for m in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
            m.reset_parameters(gen)
    plain = block(torch.float32, "xla", "dense")
    plain.load_state_dict(blk.state_dict())
    x = torch.randn((4, N, 768), generator=gen, device="cuda").to(
        torch.bfloat16)
    n1k, n2k = blk._norms(modality)
    n1p, n2p = plain._norms(modality)
    kernels.reset_launches()
    with torch.no_grad():
        attn_k, metric_k = blk.attn(n1k(x), None, tome=True)
        attn_p, metric_p = plain.attn(n1p(x.float()), None, tome=True)
        _, keep_k = bipartite_soft_matching(metric_k, r)
        assign, keep = bipartite_soft_matching(metric_p, r)
        xk = x + attn_k
        mk, sk = merge_wavg(assign, xk)
        mp, _ = merge_wavg(assign, x.float() + attn_p)
        out_k, out_p = blk._mlp_res(mk, n2k), plain._mlp_res(mp, n2p)
        whole, whole_keep = blk(x, modality, None, r)
    assert dict(kernels.LAUNCHES) == dict(_NO_LAUNCHES, attention_fwd=2,
                                          ln_mlp_fwd=2)
    assert mk.dtype == out_k.dtype == torch.bfloat16
    assert _rel(attn_k, attn_p) <= TOL and _rel(metric_k, metric_p) <= TOL
    for kp in (keep_k, keep, whole_keep):
        assert (~kp).sum(dim=1).tolist() == [r] * 4
    assert _rel(out_k[keep], out_p[keep]) <= TOL
    mass = (mk.float() * sk.float() * keep[..., None]).sum(dim=1)
    assert _rel(mass, xk.float().sum(dim=1)) <= TOL
    assert bool(torch.isfinite(whole.float()).all())


def test_device_memory_stats_on_the_card(gen):
    """``device_memory_stats`` on the card: torch's allocator figures and
    the card's total, in use <= peak <= total."""
    from avsiam_tpu_torch.utils.profiling import device_memory_stats
    x = torch.empty(1 << 20, device="cuda")
    stats = device_memory_stats()
    assert set(stats) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
    assert stats == device_memory_stats(0) == device_memory_stats("cuda")
    assert stats["bytes_in_use"] >= x.numel() * 4
    assert (stats["bytes_in_use"] <= stats["peak_bytes_in_use"]
            <= stats["bytes_limit"])
    assert stats["bytes_limit"] == torch.cuda.mem_get_info(0)[1]
