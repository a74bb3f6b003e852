"""Port parity of the audio-only finetune model (``models/audio_only.py``).

Both packages run on the CPU in float32 at ViT dim 128, 2 heads (D=64),
depth 2 with one modality-specific block, 32 mel bins x 128 frames (a 2 x 8
grid, 16 tokens), 5 classes. The port takes the JAX model's initial
parameters through ``params_from_jax`` (strict), so that the blocks_a /
blocks_u names and every norm set the JAX init makes are held too; the
inputs come from a seeded numpy stream.

- ``encode``, ``forward_pred`` and ``forward_feat``: rtol 1e-5, atol 1e-5,
  on the JAX model's default (XLA) routes and on its Pallas attention and
  'lnfres' MLP in interpret mode; the port runs its usual route, the plain
  versions on the CPU.
- Every parameter's gradient of a BCE loss on the logits: rtol 1e-4, atol
  1e-5.
- ``tr_pos=False``: the position table's gradient exactly zero, as JAX's
  ``stop_gradient`` gives; ``tr_pos=True``: not zero.
- The config reaches the blocks: 'tanh' GELU gives other logits than
  'erf', and ``mlp_impl='remat_g'`` the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsiam_tpu import configs as jc
from avsiam_tpu.models.audio_only import CAVMAEFTAudio as JaxModel
from avsiam_tpu.train.finetune import bce_with_logits as jax_bce
from avsiam_tpu_torch import configs as pc
from avsiam_tpu_torch.models import CAVMAEFTAudio
from avsiam_tpu_torch.models.pos_embed import get_2d_sincos_pos_embed
from avsiam_tpu_torch.train.finetune import bce_with_logits
from avsiam_tpu_torch.utils.weights import params_from_jax
from test_torch_port_common import VIT, array_leaves, to_np

AO_VIT = dict(VIT, depth=2)
MSD, B, CLASSES = 1, 3, 5


def jax_model(**kw):
    return JaxModel(vit=jc.ViTConfig(**dict(AO_VIT, **kw.pop("vit", {}))),
                    label_dim=CLASSES, modality_specific_depth=MSD, **kw)


def port_model(params, **kw):
    vit = pc.ViTConfig(**dict(AO_VIT, **kw.pop("vit", {})))
    model = CAVMAEFTAudio(vit, CLASSES, modality_specific_depth=MSD,
                          device="cpu", **kw)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def ao_batch(seed=0):
    """(fbank [B, 128, 32], multi-hot labels [B, 5]) float32 numpy."""
    rs = np.random.RandomState(seed)
    a = rs.randn(B, AO_VIT["audio_length"], AO_VIT["mel_bins"])
    y = (rs.rand(B, CLASSES) < 0.4).astype(np.float64)
    return a.astype(np.float32), y.astype(np.float32)


@pytest.fixture(scope="module")
def jax_params():
    """The JAX model's initial parameters (every leaf its init makes)."""
    a, _ = ao_batch()
    model = jax_model()
    return jax.device_get(jax.jit(lambda r: model.init(
        r, a, method=model.forward_pred))(jax.random.PRNGKey(0))["params"])


def test_structure_and_init(jax_params):
    """The port's parameter names are the JAX tree's, through
    ``params_from_jax`` (the load above is strict); the position table
    starts as the sin-cos table, the blocks split 1 + 1."""
    model = CAVMAEFTAudio(pc.ViTConfig(**AO_VIT), CLASSES,
                          modality_specific_depth=MSD, device="cpu")
    assert set(model.state_dict()) == set(params_from_jax(jax_params))
    assert len(model.blocks_a) == MSD and len(model.blocks_u) == 1
    grid = pc.ViTConfig(**AO_VIT).audio_grid
    assert torch.equal(model.pos_embed_a.data[0],
                       get_2d_sincos_pos_embed(AO_VIT["dim"], *grid))
    np.testing.assert_array_equal(
        np.asarray(jax_params["pos_embed_a"]), model.pos_embed_a.numpy(
            force=True))


@pytest.mark.parametrize("routes", ["xla", "pallas"])
@pytest.mark.parametrize("method", ["encode", "forward_pred",
                                    "forward_feat"])
def test_forward_matches_jax(jax_params, method, routes):
    """Each method within rtol 1e-5, atol 1e-5 of the JAX model's, on its
    default routes ('auto': XLA attention, dense MLP on the CPU) and on its
    Pallas attention and fused LN-MLP in interpret mode."""
    a, _ = ao_batch(seed=1)
    kw = (dict(attn_impl="pallas", mlp_impl="lnfres") if routes == "pallas"
          else {})
    jm = jax_model(**kw)
    want = jax.device_get(jax.jit(lambda p: jm.apply(
        {"params": p}, a, method=getattr(jm, method)))(jax_params))
    with torch.no_grad():
        got = getattr(port_model(jax_params), method)(torch.from_numpy(a))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(to_np(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tr_pos", [True, False])
def test_gradients_match_jax(jax_params, tr_pos):
    """Every parameter's gradient of the BCE loss on ``forward_pred``
    within rtol 1e-4, atol 1e-5 of JAX's; with ``tr_pos`` false the
    position table's is exactly zero on both, with it true it is not."""
    a, y = ao_batch(seed=2)
    jm = jax_model(tr_pos=tr_pos)
    want = jax.device_get(jax.jit(jax.grad(lambda p: jax_bce(jm.apply(
        {"params": p}, a, method=jm.forward_pred), jnp.asarray(y))))(
            jax_params))
    model = port_model(jax_params, tr_pos=tr_pos)
    bce_with_logits(model.forward_pred(torch.from_numpy(a)),
                    torch.from_numpy(y)).backward()
    want = params_from_jax(array_leaves(want))
    for name, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(to_np(g), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    pos = model.pos_embed_a.grad
    if tr_pos:
        assert pos is not None and pos.abs().max() > 0
        assert np.abs(want["pos_embed_a"].numpy()).max() > 0
    else:
        assert pos is None or not pos.any()
        assert not want["pos_embed_a"].numpy().any()


def test_gelu_and_mlp_impl_reach_the_blocks(jax_params):
    """'tanh' GELU gives other logits than 'erf', and JAX's 'tanh' logits;
    ``mlp_impl='remat_g'`` the same bits as 'dense' (the JAX 'auto' off the
    TPU; the port's 'auto' takes the fused LN-MLP's plain version here)."""
    a, _ = ao_batch(seed=3)
    x = torch.from_numpy(a)
    with torch.no_grad():
        erf = port_model(jax_params).forward_pred(x)
        tanh = port_model(jax_params, vit=dict(gelu="tanh")).forward_pred(x)
        dense = port_model(jax_params, mlp_impl="dense").forward_pred(x)
        remat = port_model(jax_params, mlp_impl="remat_g").forward_pred(x)
    assert not torch.allclose(erf, tanh, atol=1e-6)
    assert torch.equal(remat, dense)
    jm = jax_model(vit=dict(gelu="tanh"))
    want = jax.device_get(jax.jit(lambda p: jm.apply(
        {"params": p}, a, method=jm.forward_pred))(jax_params))
    np.testing.assert_allclose(to_np(tanh), want, rtol=1e-5, atol=1e-5)


def test_remat_g_keeps_the_gradients(jax_params):
    """``mlp_impl='remat_g'`` recomputes fc1 in the backward: every
    gradient the same bits as 'dense''s."""
    a, y = ao_batch(seed=4)
    grads = []
    for impl in ("dense", "remat_g"):
        model = port_model(jax_params, mlp_impl=impl)
        bce_with_logits(model.forward_pred(torch.from_numpy(a)),
                        torch.from_numpy(y)).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        assert (g is None) == (grads[1][name] is None), name
        assert g is None or torch.equal(g, grads[1][name]), name


def test_a_card_model_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CAVMAEFTAudio(pc.ViTConfig(**AO_VIT), CLASSES)
