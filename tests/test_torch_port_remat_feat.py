"""Port parity of ``remat_blocks``, ``forward_feat`` and ``forward_inpaint``
(``models/layers.py``, ``models/cavmae.py``).

- A two-pass step with ``remat_blocks=True`` against the JAX step with
  ``remat_blocks=True``, under ``test_torch_port_step``'s checks and
  tolerances (the JAX side on its XLA attention and dense MLP, as there),
  and bit for bit against the port's step without remat: rematerialising
  a block runs the same ops on the same inputs again.
- The recompute: under remat each trunk block's forward runs twice in a
  step, ``mm_layer_1/2`` and the decoder's once, as in JAX, where only the
  trunks' blocks are wrapped in ``nn.remat``.
- ``forward_feat`` and ``forward_inpaint`` against the JAX model's (the
  bench configuration's impls, Pallas kernels in interpret mode, float32,
  ``test_torch_port_common``'s tiny geometry): outputs to 1e-5 relative,
  masks exactly, the unpatchified shapes.
"""

import jax
import numpy as np
import pytest
import torch

from avsiam_tpu.models import CAVMAEPretrain as JaxModel
from avsiam_tpu_torch import configs as pc
from avsiam_tpu_torch.models.cavmae import CAVMAEPretrain, MaskDraws
from avsiam_tpu_torch.models.layers import ModalityBlock
from avsiam_tpu_torch.train import pretrain as ppre
from avsiam_tpu_torch.utils.weights import params_from_jax
from test_torch_port_common import (batch, configs, draws_from,
                                    recording_draws, to_np)
from test_torch_port_step import CHECKS, _check_first_step, _run

B = 9


@pytest.fixture(scope="module")
def run_remat():
    """One step of both packages with ``remat_blocks=True`` (the JAX side's
    dense MLP and XLA attention, the port's 'lnfres')."""
    return _run(dict(mlp_impl="dense", remat_blocks=True),
                dict(remat_blocks=True), n_steps=1)


@pytest.mark.parametrize("check", CHECKS)
def test_remat_step_matches_jax(run_remat, check):
    """``test_torch_port_step``'s checks of a first step (metrics, both
    passes' gradients, parameters, both Adams' moments), with remat."""
    _check_first_step(run_remat, check)


def _steps(remat: bool, n_steps: int = 2):
    """``n_steps`` port steps from one seed and draws, with or without
    remat: (state, metrics per step)."""
    _, cfg = configs(batch=B)
    cfg = pc.replace(cfg, model=pc.replace(cfg.model, remat_blocks=remat))
    state = ppre.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    a, v = (torch.from_numpy(x) for x in batch(B, seed=1))
    gen = torch.Generator().manual_seed(2)
    step = ppre.make_pretrain_step(cfg)
    metrics = []
    for i in range(n_steps):
        state, m = step(state, (a, v), gen, 1e-3 * 0.5 ** i)
        metrics.append(m)
    return state, metrics


def test_remat_step_equals_the_step_without_remat():
    """Two steps with remat against two without, from the same seed and
    draws: every metric, parameter and Adam moment the same bits."""
    (sr, mr), (sp, mp) = _steps(True), _steps(False)
    for r, p in zip(mr, mp):
        assert all(torch.equal(r[k], p[k]) for k in p)
    for (name, pr), pp in zip(sr.model.named_parameters(),
                              sp.model.parameters()):
        assert torch.equal(pr, pp), name
    for o_r, o_p in ((sr.opt1, sp.opt1), (sr.opt2, sp.opt2)):
        for st_r, st_p in zip(o_r.state.values(), o_p.state.values()):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(st_r[key], st_p[key])


def test_remat_runs_each_trunk_block_forward_again(monkeypatch):
    """A step's block forwards: with remat each call of a ``vit`` or
    ``ast`` block runs twice (the backward runs it again), a call of
    ``mm_layer_1/2`` or a decoder block once; without remat every call
    once. Pass 1 calls the vit block once per chunk and modality (10 at
    B=9), pass 2 the vit and the ast block once each."""
    counts = {}
    orig = ModalityBlock._forward

    def counting(self, *args):
        counts[self.where] = counts.get(self.where, 0) + 1
        return orig(self, *args)

    monkeypatch.setattr(ModalityBlock, "_forward", counting)
    for remat in (False, True):
        _, cfg = configs(batch=B)
        cfg = pc.replace(cfg, model=pc.replace(cfg.model,
                                               remat_blocks=remat))
        state = ppre.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
        for name, m in state.model.named_modules():
            if isinstance(m, ModalityBlock):
                m.where = name.split(".")[0]
        counts.clear()
        a, v = (torch.from_numpy(x) for x in batch(B, seed=1))
        ppre.make_pretrain_step(cfg)(state, (a, v),
                                     torch.Generator().manual_seed(2), 1e-3)
        k = 2 if remat else 1
        assert counts == dict(vit=11 * k, ast=1 * k, mm_layer_1=1,
                              mm_layer_2=1, decoder=1)


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = configs(batch=2)
    a, v = batch(2)
    key = jax.random.PRNGKey(0)
    model = JaxModel(jcfg.model)
    params = jax.device_get(jax.jit(model.init)(
        {"params": key, "mask": key, "perm": key}, a, v)["params"])
    port = CAVMAEPretrain(pcfg.model, "cpu")
    port.load_state_dict(params_from_jax(params), strict=True)
    return model, params, port, a, v


def test_forward_feat_matches_jax(setup):
    """Unmasked token features of both modalities ([B, La, C], [B, Lv,
    C]) through the vit trunk's blocks and final norms."""
    model, params, port, a, v = setup
    want = jax.jit(lambda p, a, v: model.apply(
        {"params": p}, a, v, method=JaxModel.forward_feat))(params, a, v)
    with torch.no_grad():
        got = port.forward_feat(torch.from_numpy(a), torch.from_numpy(v))
    assert got[0].shape == (2, 16, 128) and got[1].shape == (2, 9, 128)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("ratios", [(0.75, 0.75), (0.5, 0.25)])
def test_forward_inpaint_matches_jax(monkeypatch, setup, ratios):
    """The unpatchified audio image [B, 1, F, T] and frames [B, 3, H, W]
    and both masks, from the token noise the JAX forward drew, at the
    default and at other mask ratios."""
    model, params, port, a, v = setup

    def run(p, a, v):
        with recording_draws(monkeypatch) as rec:
            out = model.apply({"params": p}, a, v, *ratios,
                              method=JaxModel.forward_inpaint,
                              rngs={"mask": jax.random.PRNGKey(5)})
        return out, rec

    want, rec = jax.device_get(jax.jit(run)(params, a, v))
    d = draws_from(jax.tree_util.tree_map(np.array, rec), 1.0, 0.0, "exact")
    with torch.no_grad():
        got = port.forward_inpaint(torch.from_numpy(a), torch.from_numpy(v),
                                   *ratios, draws=MaskDraws(
                                       noise_a=d.noise_a, noise_v=d.noise_v))
    assert got[0].shape == (2, 1, 32, 128) and got[1].shape == (2, 3, 48, 48)
    for i, (g, w) in enumerate(zip(got, want)):
        if i < 2:
            np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
        else:
            np.testing.assert_array_equal(to_np(g), np.asarray(w))
    assert float(got[2].sum()) == 2 * (16 - int(16 * (1 - ratios[0])))


def test_forward_inpaint_draws_from_a_generator(setup):
    """Without draws, ``forward_inpaint`` takes its noise from the
    generator, and needs one of the two."""
    _, _, port, a, v = setup
    at, vt = torch.from_numpy(a), torch.from_numpy(v)
    with torch.no_grad():
        one = port.forward_inpaint(at, vt,
                                   generator=torch.Generator().manual_seed(1))
        two = port.forward_inpaint(at, vt,
                                   generator=torch.Generator().manual_seed(1))
        assert all(torch.equal(x, y) for x, y in zip(one, two))
        with pytest.raises(ValueError, match="draws or a generator"):
            port.forward_inpaint(at, vt)
