"""Port parity of the multi-ratio contrastive encoder's forms
(``models/cavmae.py``: 'tconcat', 'bucketed', 'packed' and 'padded').

Each form's contrastive pass is held against the JAX model's same form, in
the bench configuration's impls (the token-major Pallas attention and the
'lnfres' MLP in interpret mode), float32, at the tiny geometry of
``test_torch_port_common``, from the same weights and draws: the pooled
``ca``/``cv`` and ``loss_c`` to 1e-5 relative, ``c_acc`` exactly, and every
parameter gradient of the pass within 1e-4 of its tensor's largest value.
B=9 gives five chunks (2, 2, 2, 2, 1), ratios 0 to 0.8. Each form is also
held against the port's own 'exact' on the same draws, at B=9 and at B=4
(four chunks of one): 'padded' through the keep masks of exact's draws
(``exact_keep_masks``), as ``tests/test_mmixed_equivalence.py`` does.
"""

import jax
import numpy as np
import pytest
import torch

from avsiam_tpu import configs as jc
from avsiam_tpu.models import CAVMAEPretrain as JaxModel
from avsiam_tpu_torch import configs as pc
from avsiam_tpu_torch.models.cavmae import (CAVMAEPretrain, draw_masks,
                                            exact_keep_masks,
                                            padded_keep_masks)
from avsiam_tpu_torch.models.variants import pretrain_config
from avsiam_tpu_torch.utils.weights import params_from_jax
from test_torch_port_common import (batch, configs, draws_from,
                                    recording_draws, to_np)

B = 9
FORMS = ["tconcat", "bucketed", "packed", "padded"]


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = configs(batch=B)
    a, v = batch(B)
    key = jax.random.PRNGKey(0)
    params = jax.jit(JaxModel(jcfg.model).init)(
        {"params": key, "mask": key, "perm": key}, a, v)["params"]
    return jcfg, pcfg, jax.device_get(params), a, v


_JAX_RUNS = {}


def _jax_contrastive(setup, form):
    """The JAX model's contrastive pass in ``form``: (8-tuple, (ca, cv),
    gradients, the port's draws), once per form."""
    if form in _JAX_RUNS:
        return _JAX_RUNS[form]
    jcfg, _, params, a, v = setup
    model = JaxModel(jc.replace(jcfg.model, mmixed_impl=form))
    rngs = {"mask": jax.random.PRNGKey(3), "perm": jax.random.PRNGKey(4)}
    mp = pytest.MonkeyPatch()

    def run(params, a, v, rngs):
        with recording_draws(mp) as rec:
            def loss(p):
                out, state = model.apply(
                    {"params": p}, a, v, mae_loss_weight=0.0,
                    contrast_loss_weight=1.0, rngs=rngs,
                    capture_intermediates=lambda mdl, name:
                        name == "forward_encoder_mmixed",
                    mutable=["intermediates"])
                pooled = state["intermediates"]["forward_encoder_mmixed"][0]
                return out[0], (out, pooled)

            (_, (out, pooled)), grads = jax.value_and_grad(
                loss, has_aux=True)(params)
        return out, pooled, grads, rec

    out, pooled, grads, rec = jax.device_get(jax.jit(run)(params, a, v, rngs))
    rec = jax.tree_util.tree_map(np.array, rec)
    _JAX_RUNS[form] = (out, pooled, grads,
                       draws_from(rec, 0.0, 1.0, form))
    return _JAX_RUNS[form]


def _port(pcfg, params, form):
    port = CAVMAEPretrain(pc.replace(pcfg.model, mmixed_impl=form), "cpu")
    port.load_state_dict(params_from_jax(params), strict=True)
    return port


@pytest.mark.parametrize("check", ["values", "gradients"])
@pytest.mark.parametrize("form", FORMS)
def test_contrastive_form_matches_jax(setup, form, check):
    """The pass's pooled outputs, ``loss_c`` and ``c_acc`` ('values'), and
    every parameter gradient ('gradients'): the parameters the pass does
    not reach have a zero gradient in JAX and none in the port."""
    _, pcfg, params, a, v = setup
    jout, (jca, jcv), jgrads, draws = _jax_contrastive(setup, form)
    port = _port(pcfg, params, form)
    at, vt = torch.from_numpy(a), torch.from_numpy(v)
    if check == "values":
        with torch.no_grad():
            ca, cv = port.forward_encoder_mmixed(at, vt, draws)
            out = port(at, vt, mae_loss_weight=0.0, contrast_loss_weight=1.0,
                       draws=draws)
        for got, want in ((ca, jca), (cv, jcv), (out[0], jout[0]),
                          (out[4], jout[4])):
            np.testing.assert_allclose(to_np(got), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(to_np(out[7]), np.asarray(jout[7]))
        return
    port(at, vt, mae_loss_weight=0.0, contrast_loss_weight=1.0,
         draws=draws)[0].backward()
    grads = {n: p.grad for n, p in port.named_parameters()}
    n_reached = 0
    for name, want in params_from_jax(jgrads).items():
        scale = float(want.abs().max())
        if grads[name] is None:
            assert scale == 0.0, name
            continue
        err = float((grads[name] - want).abs().max())
        assert err <= 1e-4 * max(scale, 1e-12), (name, err, scale)
        n_reached += 1
    assert n_reached > 10


@pytest.mark.parametrize("n", [B, 4], ids=["five_chunks", "four_chunks"])
@pytest.mark.parametrize("form", FORMS)
def test_contrastive_form_matches_port_exact(setup, form, n):
    """On the draws of 'exact' (drawn from a seeded generator), each form
    gives 'exact''s pooled outputs to 1e-5: 'tconcat', 'bucketed' and
    'packed' take the draws as they are, 'padded' encodes the full
    sequences under the keep masks of those draws."""
    _, pcfg, params, a, v = setup
    exact = _port(pcfg, params, "exact")
    port = _port(pcfg, params, form)
    at, vt = torch.from_numpy(a[:n]), torch.from_numpy(v[:n])
    draws = draw_masks(exact.cfg, n, torch.Generator().manual_seed(n), "cpu",
                       mae=False)
    with torch.no_grad():
        want = exact.forward_encoder_mmixed(at, vt, draws)
        if form == "padded":
            keep_a, keep_v = exact_keep_masks(exact.cfg, draws)
            got = (port._encode_contrastive(port.vit.embed_audio(at), "a",
                                            keep_a),
                   port._encode_contrastive(port.vit.embed_video(vt), "v",
                                            keep_v))
        else:
            got = port.forward_encoder_mmixed(at, vt, draws)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_padded_draws_taken_ahead_equal_the_forward_draws(setup, monkeypatch):
    """'padded''s pass-1 draws taken ahead (``draw_step_masks``, the
    graphed step's way) are the ones its eager forward takes from the same
    seed: the fields of its layout, and the same outputs."""
    import avsiam_tpu_torch.models.cavmae as pcavmae
    from avsiam_tpu_torch.train.pretrain import draw_step_masks
    _, pcfg, params, a, v = setup
    port = _port(pcfg, params, "padded")
    at, vt = torch.from_numpy(a), torch.from_numpy(v)
    seen = []
    orig = pcavmae.draw_masks

    def record(*args, **kw):
        seen.append(orig(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(pcavmae, "draw_masks", record)
    with torch.no_grad():
        out = port(at, vt, mae_loss_weight=0.0, contrast_loss_weight=1.0,
                   generator=torch.Generator().manual_seed(5))
    ahead = draw_step_masks(port.cfg, B, torch.Generator().manual_seed(5),
                            "cpu")[0]
    assert ahead.chunk_a is None and ahead.padded_a is not None
    assert ahead.noise_a is None
    for got, want in zip(ahead.tensors(), seen[0].tensors()):
        assert (got is None) == (want is None)
        assert got is None or torch.equal(got, want)
    with torch.no_grad():
        again = port(at, vt, mae_loss_weight=0.0, contrast_loss_weight=1.0,
                     draws=ahead)
    assert torch.equal(out[0], again[0])


def test_padded_draws_refuse_the_chunked_layout():
    """Static draw buffers of one layout refuse the other: a graphed step
    of 'padded' cannot take 'exact''s draws, or the reverse."""
    _, pcfg = configs(batch=B)
    gen = torch.Generator().manual_seed(0)
    exact = draw_masks(pcfg.model, B, gen, "cpu", mae=False)
    padded = draw_masks(pc.replace(pcfg.model, mmixed_impl="padded"), B, gen,
                        "cpu", mae=False)
    for dst, src in ((exact, padded), (padded, exact)):
        with pytest.raises(ValueError, match="differ from the buffers"):
            dst.copy_(src)


def test_padded_never_masks_a_whole_sample():
    """At ViT-B's geometry the smallest keep counts of 'padded' are
    int(512 * 0.2) = 102 audio and int(196 * 0.2) = 39 video tokens, so no
    sample has every key masked: the accepted divergence of an all-masked
    sample (ROADMAP C) never arises in this form. Each sample keeps exactly
    its chunk's count."""
    cfg = pc.replace(pretrain_config("base"), mmixed_impl="padded")
    n = 64
    d = draw_masks(cfg, n, torch.Generator().manual_seed(1), "cpu", mae=False)
    keep_a, keep_v = padded_keep_masks(cfg, d)
    chunk = torch.empty(n, dtype=torch.long)
    chunk[d.perm_a] = torch.arange(n) // 13
    want_a = torch.tensor([512, 409, 307, 204, 102])[chunk]
    chunk[d.perm_v] = torch.arange(n) // 13
    want_v = torch.tensor([196, 156, 117, 78, 39])[chunk]
    assert torch.equal(keep_a.sum(1), want_a)
    assert torch.equal(keep_v.sum(1), want_v)
    assert int(keep_a.sum(1).min()) == 102 and int(keep_v.sum(1).min()) == 39


def test_bucketed_masks_only_where_it_pads(monkeypatch):
    """'bucketed' passes no key mask where a chunk's keep count is already
    a multiple of 128 (``avsiam_tpu/models/cavmae.py:380-383``), so no
    kernel runs masked where JAX runs unmasked: at 128 audio tokens chunk
    0 (ratio 0) keeps all 128; every other chunk is padded and masked."""
    import avsiam_tpu_torch.models.layers as players
    _, pcfg = configs(batch=5, vit=dict(audio_length=1024))
    cfg = pc.replace(pcfg.model, mmixed_impl="bucketed")
    port = CAVMAEPretrain(cfg, "cpu")
    calls = []
    orig = players.attention_qkv

    def record(xqkv, heads, key_valid, impl, shards=1):
        calls.append((tuple(xqkv.shape[:2]), key_valid is None))
        return orig(xqkv, heads, key_valid, impl, shards=shards)

    monkeypatch.setattr(players, "attention_qkv", record)
    a, v = batch(5)
    a = np.concatenate([a] * 8, axis=1)  # 1024 frames: a 2 x 64 grid
    with torch.no_grad():
        port.forward_encoder_mmixed(
            torch.from_numpy(a), torch.from_numpy(v),
            draw_masks(cfg, 5, torch.Generator().manual_seed(0), "cpu",
                       mae=False))
    # per chunk, audio (keeps 128, 102, 76, 51, 25 -> 128 rows), then video
    # (keeps 9, 7, 5, 3, 1 -> 128 rows)
    assert calls == [c for i in range(5)
                     for c in (((1, 128), i == 0), ((1, 128), False))]


def test_unknown_mmixed_impl_raises():
    """No silent fallback: a misspelt form raises where the model is
    built, as the JAX dispatch asserts."""
    _, pcfg = configs(batch=B)
    with pytest.raises(ValueError, match="mmixed_impl 'paded'"):
        CAVMAEPretrain(pc.replace(pcfg.model, mmixed_impl="paded"), "cpu")


def test_the_default_config_builds():
    """``pretrain_config('base')`` (ViT-B, 'padded', ``remat_blocks``
    False: the JAX config's defaults) builds on the CPU."""
    cfg = pretrain_config("base")
    assert cfg.mmixed_impl == "padded"
    model = CAVMAEPretrain(cfg, "cpu")
    assert model.vit.blocks[0].attn.qkv.weight.shape == (2304, 768)
