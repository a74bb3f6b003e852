"""Port parity of the model: blocks, the CAVMAEPretrain 8-tuple, weight
carrying and initialisation.

The JAX model runs in the bench configuration's impls (attention through the
token-major Pallas kernel, MLP 'lnfres', 'exact' multi-ratio encoder;
interpret mode on the CPU), float32, at the tiny geometry of
``test_torch_port_common``. Both packages get the same weights
(``params_from_jax``), inputs and random draws (``record_draws``).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsiam_tpu.models import CAVMAEPretrain as JaxModel
from avsiam_tpu.models.layers import ModalityBlock as JaxBlock
from avsiam_tpu_torch.models.cavmae import CAVMAEPretrain
from avsiam_tpu_torch.models.layers import ModalityBlock
from avsiam_tpu_torch.utils.weights import params_from_jax
from test_torch_port_common import batch, configs, record_draws, to_np

B = 9  # five contrastive chunks (2, 2, 2, 2, 1): ratios 0 to 0.8


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = configs(batch=B)
    a, v = batch(B)
    key = jax.random.PRNGKey(0)
    model = JaxModel(jcfg.model)
    params = jax.jit(model.init)({"params": key, "mask": key, "perm": key},
                                 a, v)["params"]
    return jcfg, pcfg, model, jax.device_get(params), a, v


def _port(pcfg, params):
    port = CAVMAEPretrain(pcfg.model, "cpu")
    port.load_state_dict(params_from_jax(params), strict=True)
    return port


@pytest.mark.parametrize("mae_w,con_w", [(0.0, 1.0), (1.0, 0.0)],
                         ids=["contrastive", "mae"])
def test_forward_8_tuple_matches_jax(monkeypatch, setup, mae_w, con_w):
    """Every element of the 8-tuple: losses to 1e-5 relative (float32
    through a depth-1 model), masks exactly, c_acc exactly, and None where
    JAX returns None."""
    jcfg, pcfg, model, params, a, v = setup
    rngs = {"mask": jax.random.PRNGKey(3), "perm": jax.random.PRNGKey(4)}
    jout, draws = record_draws(monkeypatch, model, params, a, v, mae_w,
                               con_w, rngs)
    out = _port(pcfg, params)(torch.from_numpy(a), torch.from_numpy(v),
                              mae_loss_weight=mae_w,
                              contrast_loss_weight=con_w, draws=draws)
    assert len(out) == len(jout) == 8
    for i, (got, want) in enumerate(zip(out, jout)):
        if want is None:
            assert got is None, i
        elif i in (5, 6, 7):  # masks and c_acc
            np.testing.assert_array_equal(to_np(got), np.asarray(want),
                                          err_msg=str(i))
        else:
            np.testing.assert_allclose(to_np(got), np.asarray(want),
                                       rtol=1e-5, atol=1e-6, err_msg=str(i))
    assert float(out[0].detach()) > 0


@pytest.mark.parametrize("modality", ["a", "av"])
def test_modality_block_matches_jax(modality):
    """One block, output and the gradient of its input to 1e-5 / 1e-4. The
    None/'a'/'v' routings also run inside the model tests; 'av' (joint
    attention, returning the fused audio rows and the pre-MLP video tail)
    only here."""
    jcfg, pcfg = configs()
    c = jcfg.model.vit
    rs = np.random.RandomState(5)
    x = rs.randn(2, 21, c.dim).astype(np.float32)

    class Wrap(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            blk = JaxBlock(c.dim, c.num_heads, c.mlp_ratio, True,
                           c.block_ln_eps, jnp.float32, "pallas", "erf",
                           "lnfres", name="blk")
            for m in (None, "a", "v"):  # materialise every norm set
                blk(x, m)
            if modality == "av":
                return blk((x[:, :12], x[:, 12:]), modality)
            return blk(x, modality)

    params = jax.jit(Wrap().init)(jax.random.PRNGKey(1), x)["params"]
    # perturb the LN parameters so that each routing reads its own set
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(p.size),
                                              p.shape), params)
    params = jax.device_get(params)

    def jloss(x):
        out = Wrap().apply({"params": params}, x)
        flat = jnp.concatenate([o.reshape(-1) for o in jax.tree_util.tree_leaves(out)])
        return jnp.sum(flat * jnp.arange(flat.size) / flat.size), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(x))
    p = pcfg.model.vit
    port = ModalityBlock(p.dim, p.num_heads, p.mlp_ratio, True, p.block_ln_eps,
                         torch.float32, "auto", "erf", "lnfres", "cpu")
    sd = {k.split(".", 1)[1]: t for k, t in params_from_jax(params).items()}
    port.load_state_dict(sd, strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt, modality) if modality != "av" else port(
        (xt[:, :12], xt[:, 12:]), modality)
    outs = out if isinstance(out, tuple) else (out,)
    flat = torch.cat([o.reshape(-1) for o in outs])
    (flat * torch.arange(flat.numel()) / flat.numel()).sum().backward()
    for got, want in zip(outs, jax.tree_util.tree_leaves(jout)):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-5)


def test_params_from_jax_covers_every_parameter(setup):
    _, pcfg, _, params, _, _ = setup
    sd = params_from_jax(params)
    port = CAVMAEPretrain(pcfg.model, "cpu")
    assert set(sd) == set(port.state_dict())
    for name, t in port.state_dict().items():
        assert t.shape == sd[name].shape, name
    w = params["vit"]["blocks_0"]["attn"]["qkv"]["kernel"]
    np.testing.assert_array_equal(sd["vit.blocks.0.attn.qkv.weight"].numpy(),
                                  np.asarray(w).T)


def test_init_distributions_match_jax(setup):
    """Same distributions, not the same bits: zeros and ones exactly where
    JAX has them; elsewhere mean within 0.1 std and std within 10% (tensors
    of >= 4096 values), and the +-2-std truncation."""
    _, pcfg, _, params, _, _ = setup
    ref = params_from_jax(params)
    port = CAVMAEPretrain(pcfg.model, "cpu",
                          torch.Generator().manual_seed(7)).state_dict()
    n_checked = 0
    for name, want in ref.items():
        got = port[name]
        if torch.all(want == 0) or torch.all(want == 1):
            assert torch.equal(got, want), name
            continue
        if want.numel() < 4096:
            continue
        std = float(want.std())
        assert abs(float(got.mean())) < 0.1 * std, name
        assert abs(float(got.std()) / std - 1) < 0.1, name
        assert float(got.abs().max()) <= 2.0 * std / 0.8796 * 1.03, name
        n_checked += 1
    assert n_checked > 10


def test_default_device_is_the_card():
    """Entry points run on the GPU unless asked for the CPU; without a card
    they raise instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, pcfg = configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        CAVMAEPretrain(pcfg.model)
