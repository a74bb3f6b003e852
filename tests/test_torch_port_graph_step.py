"""The port's step as one device program, on the CPU: the one Adam form
(fused, capturable, a tensor learning rate), the passes' draws taken ahead
of the body, the body against the eager step, and the graphed step's
refusal of the CPU. Its capture and replays run on the card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).

Tolerances (float32): the Adam form against the JAX package's
``masked_torch_adam`` with the same gradients, moments within 1e-5 of each
tensor's largest value and every parameter within 1e-3 lr + 1e-6 (the step
test's bounds, ``tests/test_torch_port_step.py``, here for every element);
draws and the body against the eager step, the same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from avsiam_tpu import configs as jc
from avsiam_tpu.train.optim import masked_torch_adam as jax_masked_adam
from avsiam_tpu.train.pretrain import _apply as jax_apply
from avsiam_tpu_torch import configs as pc
from avsiam_tpu_torch import kernels
from avsiam_tpu_torch.models import cavmae as pcavmae
from avsiam_tpu_torch.models.cavmae import MaskDraws
from avsiam_tpu_torch.train import pretrain as ppre
from avsiam_tpu_torch.train.optim import lr_tensor, masked_torch_adam
from test_torch_port_common import array_leaves, batch, configs

B = 6
LRS = (1e-3, 5e-4, 2e-3)  # one per step, written with fill_
SHAPES = {"w": (5, 7), "b": (7,), "still": (3,), "frozen": (4, 2)}
TOUCHED = ("w", "b", "still")  # "still" is touched but gets a zero gradient


class _Params(nn.Module):
    def __init__(self, values):
        super().__init__()
        for k, val in values.items():
            self.register_parameter(k, nn.Parameter(torch.from_numpy(val)))


@pytest.mark.parametrize("weight_decay", [5e-7, 5e-2],
                         ids=["default_decay", "large_decay"])
def test_adam_form_matches_jax_masked_adam(weight_decay):
    """Three steps of the port's Adam (its lr tensor set with ``fill_``
    before each) and of the JAX ``masked_torch_adam`` + the step's
    ``_apply`` (lr a traced scalar) on the same gradients: parameters and
    both moments agree, and the untouched parameter neither moves nor gets
    moments."""
    rs = np.random.RandomState(0)
    p0 = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    # a pass reaches no untouched parameter, so JAX's gradient there is 0
    # (optax.masked passes an untouched leaf's update through as it is)
    grads = [{k: (rs.randn(*s).astype(np.float32) if k in ("w", "b")
                  else np.zeros(s, np.float32))
              for k, s in SHAPES.items()} for _ in LRS]
    module = _Params({k: v.copy() for k, v in p0.items()})
    ocfg = pc.OptimizerConfig(weight_decay=weight_decay)
    opt = masked_torch_adam(module, ocfg, lambda n: n in TOUCHED,
                            lr_tensor(ocfg, "cpu"))
    lr = opt.param_groups[0]["lr"]
    assert lr.dim() == 0 and lr.dtype == torch.float32
    assert opt.defaults["fused"] and opt.defaults["capturable"]
    tx = jax_masked_adam(jc.OptimizerConfig(weight_decay=weight_decay),
                         {k: k in TOUCHED for k in SHAPES})
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jparams)
    for g, step_lr in zip(grads, LRS):
        for n, p in module.named_parameters():
            p.grad = torch.from_numpy(g[n]) if n in TOUCHED else None
        lr.fill_(step_lr)
        opt.step()
        jparams, jstate = jax_apply(tx, {k: jnp.asarray(v) for k, v in
                                         g.items()}, jstate, jparams,
                                    jnp.float32(step_lr))
    adam = jstate.inner_state[1]
    mu, nu = array_leaves(adam.mu), array_leaves(adam.nu)
    assert set(mu) == set(nu) == set(TOUCHED)
    for n, p in module.named_parameters():
        want = np.asarray(jparams[n])
        assert np.abs(p.detach().numpy() - want).max() <= 1e-3 * max(LRS) \
            + 1e-6, n
        if n not in TOUCHED:
            assert np.array_equal(p.detach().numpy(), p0[n]) and p not in \
                opt.state, n
            continue
        for key, jm in (("exp_avg", mu), ("exp_avg_sq", nu)):
            got = opt.state[p][key].numpy()
            scale = max(np.abs(jm[n]).max(), 1e-12)
            assert np.abs(got - jm[n]).max() <= 1e-5 * scale, (n, key)
    assert float(opt.state[module.w]["step"]) == len(LRS)


def _tiny(seed=0):
    """The port's tiny CPU configuration (``configs``) and a state made
    from ``seed``."""
    _, cfg = configs(batch=B)
    return cfg, ppre.init_state(cfg, torch.Generator().manual_seed(seed),
                                "cpu")


def _batch():
    return tuple(torch.from_numpy(x) for x in batch(B, seed=1))


def _record_forward_draws(monkeypatch, cfg, state, a, v, generator):
    """The draws each eager forward takes from ``generator`` itself (pass 1
    contrastive, then pass 2 MAE), recorded by wrapping the model's
    ``draw_masks``."""
    seen = []
    orig = pcavmae.draw_masks

    def record(*args, **kw):
        seen.append(orig(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(pcavmae, "draw_masks", record)
    for mae_w, con_w in ((0.0, 1.0), (1.0, 0.0)):
        state.model(a, v, mae_loss_weight=mae_w, contrast_loss_weight=con_w,
                    generator=generator)
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("which", [0, 1], ids=["contrastive", "mae"])
def test_draws_taken_ahead_equal_the_forward_draws(monkeypatch, which):
    """``draw_step_masks`` gives each pass the very draws its eager forward
    takes from the same generator seed, field by field (fields the pass
    does not draw stay None)."""
    cfg, state = _tiny()
    a, v = _batch()
    want = _record_forward_draws(monkeypatch, cfg, state, a, v,
                                 torch.Generator().manual_seed(3))
    got = ppre.draw_step_masks(cfg.model, B, torch.Generator().manual_seed(3),
                               "cpu")
    assert len(want) == 2
    for g, w in zip(got[which].tensors(), want[which].tensors()):
        assert (g is None) == (w is None)
        assert g is None or torch.equal(g, w)
    assert (got[which].noise_a is None) == (which == 0)
    assert (got[which].perm_a is None) == (which == 1)


def _moments(state):
    return [(st["exp_avg"].clone(), st["exp_avg_sq"].clone(),
             st["step"].clone()) for o in (state.opt1, state.opt2)
            for st in o.state.values()]


def _assert_same_bits(got, want):
    """Equal metrics (per step), parameters and moments, bit for bit."""
    for gm, wm in zip(got["metrics"], want["metrics"]):
        assert gm.keys() == wm.keys()
        for k in gm:
            assert torch.equal(gm[k], wm[k]), k
    for (n, g), w in zip(got["model"].named_parameters(),
                         want["model"].parameters()):
        assert torch.equal(g, w), n
    assert len(got["moments"]) == len(want["moments"]) > 0
    for g, w in zip(got["moments"], want["moments"]):
        assert all(torch.equal(x, y) for x, y in zip(g, w))


def _eager_steps(n_steps=2):
    """``make_pretrain_step`` over ``n_steps``, draws from a seeded
    generator, lr from ``LRS``."""
    cfg, state = _tiny()
    step, gen, ab = ppre.make_pretrain_step(cfg), torch.Generator(), _batch()
    gen.manual_seed(5)
    metrics = []
    for s in range(n_steps):
        state, m = step(state, ab, gen, LRS[s])
        metrics.append(m)
    assert state.step == n_steps
    return dict(metrics=metrics, model=state.model, moments=_moments(state))


def test_step_body_with_drawn_masks_equals_the_eager_step():
    """The body fed the draws ``draw_step_masks`` takes from the same seed
    and a tensor lr (written into ``state.lr``) gives the eager step's
    metrics, parameters and moments bit for bit."""
    cfg, state = _tiny()
    gen, (a, v) = torch.Generator().manual_seed(5), _batch()
    metrics = []
    for s in range(2):
        draws = ppre.draw_step_masks(cfg.model, B, gen, "cpu")
        state.lr.fill_(torch.tensor(LRS[s]))
        metrics.append(ppre.pretrain_step_body(cfg, state, a, v, *draws))
    _assert_same_bits(dict(metrics=metrics, model=state.model,
                           moments=_moments(state)), _eager_steps())


def test_eager_step_equals_passes_that_draw_in_the_forward():
    """The eager step, which draws both passes' masks before the body,
    against the passes written out with each forward drawing its own masks
    from the generator (the step before the draws moved out of it): the
    same bits."""
    cfg, state = _tiny()
    gen, (a, v) = torch.Generator().manual_seed(5), _batch()
    metrics = []
    for s in range(2):
        state.lr.fill_(LRS[s])
        outs = []
        for opt, mae_w, con_w in ((state.opt1, 0.0, 1.0),
                                  (state.opt2, 1.0, 0.0)):
            state.model.zero_grad(set_to_none=True)
            out = state.model(a, v, cfg.masking_ratio_a, cfg.masking_ratio,
                              mae_loss_weight=mae_w,
                              contrast_loss_weight=con_w, generator=gen)
            out[0].backward()
            ppre._apply(opt)
            outs.append(out)
        metrics.append(dict(loss=outs[1][0], loss_c=outs[0][4],
                            c_acc=outs[0][7], loss_mae=outs[1][1],
                            loss_mae_a=outs[1][2], loss_mae_v=outs[1][3]))
    _assert_same_bits(dict(metrics=metrics, model=state.model,
                           moments=_moments(state)), _eager_steps())


def test_both_adams_read_one_lr_tensor():
    """One 0-d float32 tensor at ``cfg.opt.lr`` serves both Adams; the step
    writes it in place, never replacing a group's lr."""
    cfg, state = _tiny()
    lr = state.lr
    assert lr.dim() == 0 and float(lr) == np.float32(cfg.opt.lr)
    assert all(g["lr"] is lr for o in (state.opt1, state.opt2)
               for g in o.param_groups)
    step = ppre.make_pretrain_step(cfg)
    step(state, _batch(), torch.Generator().manual_seed(0), 2.5e-4)
    assert state.lr is lr and float(lr) == np.float32(2.5e-4)


def test_eager_step_needs_draws_or_a_generator():
    cfg, state = _tiny()
    with pytest.raises(ValueError, match="generator"):
        ppre.make_pretrain_step(cfg)(state, _batch(), None, 1e-4)


def test_graphed_step_refuses_the_cpu():
    """No fallback: a state on the CPU is refused at the graphed step's
    first call, which runs nothing eagerly."""
    cfg, state = _tiny()
    before = [p.detach().clone() for p in state.model.parameters()]
    step = ppre.make_graphed_pretrain_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA device"):
        step(state, _batch(), torch.Generator().manual_seed(0), 1e-4)
    assert state.step == 0 and all(
        torch.equal(p, q) for p, q in zip(state.model.parameters(), before))


def test_mask_draws_copy_into_static_buffers():
    """``MaskDraws.copy_`` writes every drawn tensor in place, and refuses
    draws of another batch or with other fields without writing any."""
    cfg, _ = _tiny()
    gen = torch.Generator().manual_seed(0)
    static = ppre.draw_step_masks(cfg.model, B, gen, "cpu")
    ids = [id(t) for d in static for t in d.tensors()]
    fresh = ppre.draw_step_masks(cfg.model, B, gen, "cpu")
    for s, f in zip(static, fresh):
        s.copy_(f)
        assert all(x is None or torch.equal(x, y)
                   for x, y in zip(s.tensors(), f.tensors()))
    assert ids == [id(t) for d in static for t in d.tensors()]
    before = [t.clone() for t in static[1].tensors() if t is not None]
    for bad in (ppre.draw_step_masks(cfg.model, B - 1, gen, "cpu")[1],
                fresh[0], MaskDraws(noise_a=fresh[1].noise_a)):
        with pytest.raises(ValueError, match="differ"):
            static[1].copy_(bad)
    assert all(torch.equal(x, y) for x, y in zip(
        before, [t for t in static[1].tensors() if t is not None]))


def test_add_launches_adds_a_replay():
    before = dict(kernels.LAUNCHES)
    kernels.add_launches({"attention_fwd": 3, "mlp_dw": 2})
    try:
        assert kernels.LAUNCHES == dict(
            before, attention_fwd=before["attention_fwd"] + 3,
            mlp_dw=before["mlp_dw"] + 2)
    finally:
        kernels.LAUNCHES.update(before)
