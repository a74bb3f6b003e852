"""Port parity of the finetune model and step (``models/cavmae_ft.py``,
``train/finetune.py``, ``train/param_groups.py``).

Both packages run on the CPU in float32 at a tiny geometry: ViT dim 128, 2
heads (D=64), depth 2, 32 mel bins x 128 frames (16 audio tokens), one 48 x
48 frame (9 video tokens) in training and 3 in eval, 10 classes. The JAX
model runs its Pallas routes (attention 'pallas', MLP 'lnfres') in
interpret mode, but for the steps outside 'mm_grad' and under
``freeze_base``, which are about the optimizer and take its XLA attention
and dense MLP; the port runs its usual path, the plain versions on the
CPU.
The port takes the JAX model's initial parameters (``params_from_jax``,
strict), and the inputs come from a seeded numpy stream.

- The forward in every mode, train and eval forms, and ``forward_feat``:
  within 1e-5 relative (max |delta| / max |JAX|).
- Three 'mm_grad' steps, the routing draws chosen among JAX's keys to take
  the fused, the audio and the video loss once each, against the JAX
  ``make_finetune_step`` with ``parity_optimizer=True`` (its gated Adam):
  the loss within 1e-5 relative; each parameter, both Adam moments within
  1e-4 of the tensor's largest value; each parameter's step count exactly.
  Adam's update is about lr g / (|g| + eps), so an element whose gradient
  is rounding noise may move by up to lr either way: the rates here (base
  1e-5, heads 4e-5, fusion layers 2e-5) keep that under 1e-4. A parameter
  JAX's gate leaves alone is left bit for bit, and one it moves moves.
- A step outside 'mm_grad' ('audioonly' under BCE, 'joint_av' under CE),
  with ``parity_optimizer`` off and on (the default): every parameter,
  moment and count as JAX's plain Adam, the parameters the mode's loss
  does not reach moved on their weight decay alone; the mode's train and
  eval outputs equal JAX's within 1e-5.
- ``freeze_base``: the trunk stays bit for bit, the heads move as JAX's.
- ``ft_touched`` and ``ft_group`` against JAX over every parameter name,
  and ``ft_touched`` against the parameters autograd reaches from each
  branch's loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from avsiam_tpu import configs as jc
from avsiam_tpu.models.cavmae_ft import CAVMAEFinetune as JaxModel
from avsiam_tpu.train import finetune as jft
from avsiam_tpu.train import param_groups as jpg
from avsiam_tpu_torch import configs as pc
from avsiam_tpu_torch.models.cavmae_ft import MODES, CAVMAEFinetune
from avsiam_tpu_torch.train import finetune as ft
from avsiam_tpu_torch.train import param_groups as pg
from avsiam_tpu_torch.utils.weights import params_from_jax, port_name
from test_torch_port_common import VIT, array_leaves, to_np

FT_VIT = dict(VIT, depth=2)
B, CLASSES, FRAMES = 3, 10, 3
LR, HEAD_LR, MM_LR = 1e-5, 4.0, 2.0


def ft_configs(ftmode="mm_grad", loss="BCE", kernels=True, **kw):
    """(JAX FinetuneConfig, port FinetuneConfig) at the tiny geometry; the
    JAX model on its Pallas routes, or with ``kernels=False`` on its XLA
    attention and dense MLP."""
    def make(c, **model_kw):
        model = c.CAVMAEFTConfig(vit=c.ViTConfig(**FT_VIT),
                                 label_dim=CLASSES, num_eval_frames=FRAMES,
                                 **model_kw)
        return c.FinetuneConfig(model=model, opt=c.OptimizerConfig(lr=LR),
                                batch_size=B, head_lr=HEAD_LR, mm_lr=MM_LR,
                                ftmode=ftmode, loss=loss, **kw)

    jax_impls = (dict(attn_impl="pallas", mlp_impl="lnfres") if kernels
                 else dict(attn_impl="xla", mlp_impl="dense"))
    return (make(jc, **jax_impls),
            make(pc, attn_impl="auto", mlp_impl="lnfres"))


def ft_batch(seed=0, frames=1, loss="BCE"):
    """(fbank [B, 128, 32], frames [B, frames, 3, 48, 48], labels [B, 10])
    float32 numpy: multi-hot labels for BCE, rows summing to 1 for CE."""
    rs = np.random.RandomState(seed)
    a = rs.randn(B, FT_VIT["audio_length"], FT_VIT["mel_bins"])
    v = rs.randn(B, frames, 3, FT_VIT["img_size"], FT_VIT["img_size"])
    if loss == "BCE":
        y = (rs.rand(B, CLASSES) < 0.3).astype(np.float64)
    else:
        y = rs.dirichlet(np.ones(CLASSES) * 0.3, size=B)
    return tuple(x.astype(np.float32) for x in (a, v, y))


def rel(got, want):
    got, want = to_np(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def jax_params():
    """The JAX model's initial parameters (every leaf its init makes)."""
    jcfg, _ = ft_configs()
    a, v, _ = ft_batch()
    model = JaxModel(jcfg.model)
    return jax.device_get(jax.jit(lambda r: model.init(
        r, a, v, "mm_grad", False))(jax.random.PRNGKey(0))["params"])


def port_model(pcfg, jax_params):
    model = CAVMAEFinetune(pcfg.model, "cpu")
    model.load_state_dict(params_from_jax(jax_params), strict=True)
    return model


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("is_eval", [False, True], ids=["train", "eval"])
@pytest.mark.parametrize("mode", MODES)
def test_forward_matches_jax(jax_params, mode, is_eval):
    """Every output of every mode within 1e-5 relative of the JAX model's
    (eval: 3 frames a clip, 'mm_grad' and 'joint_av' fusing each)."""
    jcfg, pcfg = ft_configs()
    a, v, _ = ft_batch(seed=1, frames=FRAMES if is_eval else 1)
    want = jax.device_get(jax.jit(lambda p: JaxModel(jcfg.model).apply(
        {"params": p}, a, v, mode, is_eval))(jax_params))
    with torch.no_grad():
        got = port_model(pcfg, jax_params)(torch.from_numpy(a),
                                           torch.from_numpy(v), mode, is_eval)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert rel(g, w) <= 1e-5


def test_forward_feat_matches_jax(jax_params):
    """``forward_feat`` on a [B, 3, H, W] frame: both token sets within
    1e-5 relative."""
    jcfg, pcfg = ft_configs()
    a, v, _ = ft_batch(seed=2)
    v = v[:, 0]
    want = jax.device_get(jax.jit(lambda p: JaxModel(jcfg.model).apply(
        {"params": p}, a, v, method=JaxModel.forward_feat))(jax_params))
    with torch.no_grad():
        got = port_model(pcfg, jax_params).forward_feat(torch.from_numpy(a),
                                                        torch.from_numpy(v))
    for g, w in zip(got, want, strict=True):
        assert rel(g, w) <= 1e-5


def test_a_mode_off_the_list_is_refused(jax_params):
    _, pcfg = ft_configs()
    a, v, _ = ft_batch()
    with pytest.raises(ValueError, match="unknown mode"):
        port_model(pcfg, jax_params)(torch.from_numpy(a),
                                     torch.from_numpy(v), "fused")


# ------------------------------------------------------- parameter groups
def _jax_paths(jax_params):
    return list(traverse_util.flatten_dict(jax_params, sep="/"))


def test_param_groups_match_jax(jax_params):
    """``ft_touched`` for each branch and ``ft_group``, over every
    parameter name, equal the JAX predicates on the same parameter's path;
    the names are the model's own."""
    _, pcfg = ft_configs()
    names = {n for n, _ in CAVMAEFinetune(pcfg.model, "cpu")
             .named_parameters()}
    paths = _jax_paths(jax_params)
    assert {port_name(tuple(p.split("/")))[0] for p in paths} == names
    groups = set()
    for path in paths:
        name = port_name(tuple(path.split("/")))[0]
        for branch in ft.BRANCHES:
            assert pg.ft_touched(name, branch) == \
                jpg.ft_touched(path, branch), (name, branch)
        assert pg.ft_group(name) == jpg.ft_group(path), name
        groups.add(pg.ft_group(name))
    assert groups == set(ft.GROUPS)


@pytest.mark.parametrize("branch", ft.BRANCHES)
def test_each_branch_reaches_its_touched_set(jax_params, branch):
    """The parameters autograd gives a gradient from a branch's loss are
    exactly ``ft_touched``'s (no parameter is reached with a gradient the
    gate drops, none gated in without one); every reached gradient has a
    nonzero element (``derive_touched_mask``)."""
    _, pcfg = ft_configs()
    model = port_model(pcfg, jax_params)
    a, v, y = (torch.from_numpy(x) for x in ft_batch(seed=3))
    outs = dict(zip(ft.BRANCHES, model(a, v, "mm_grad")))
    ft.bce_with_logits(outs[branch], y).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    reached = {n for n, g in grads.items() if g is not None}
    assert reached == {n for n in grads if pg.ft_touched(n, branch)}
    mask = pg.derive_touched_mask(grads)
    assert {n for n, t in mask.items() if t} == reached


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("loss", ["BCE", "CE"])
def test_losses_match_jax(loss):
    rs = np.random.RandomState(4)
    x = (rs.randn(5, CLASSES) * 4).astype(np.float32)
    _, _, y = ft_batch(seed=5, loss=loss)
    y = np.concatenate([y, y[:2]])
    want = (jft.bce_with_logits if loss == "BCE"
            else jft.ce_with_soft_targets)(jnp.asarray(x), jnp.asarray(y))
    got = (ft.bce_with_logits if loss == "BCE"
           else ft.ce_with_soft_targets)(torch.from_numpy(x),
                                         torch.from_numpy(y))
    assert rel(got, want) <= 1e-6


# -------------------------------------------------------- the 'mm_grad' step
def _route_keys():
    """A JAX key whose first three routing draws take 'av', 'a' and 'v'
    once each (``make_finetune_step`` draws step n's from fold_in(key,
    n)), and those draws."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        u = [float(jax.random.uniform(jax.random.fold_in(key, n)))
             for n in range(3)]
        if {ft.route(x) for x in u} == set(ft.BRANCHES):
            return key, u
    raise AssertionError("no key takes every branch in three steps")


def _port_adam(model, opt):
    """{name: (exp_avg, exp_avg_sq, step)} of the port's Adam; a parameter
    it never stepped has zero moments and count."""
    out = {}
    for name, p in model.named_parameters():
        st = opt.state.get(p, {})
        z = torch.zeros_like(p)
        out[name] = (st.get("exp_avg", z).clone(),
                     st.get("exp_avg_sq", z).clone(),
                     int(st.get("step", torch.zeros(())).item()))
    return out


def _jax_tree(tree):
    return params_from_jax(array_leaves(jax.device_get(tree)))


def _run_jax(jcfg, jax_params, steps, key, loss="BCE"):
    """``steps`` JAX steps from ``jax_params`` on per-step batches:
    [(loss, state)]."""
    jmodel = JaxModel(jcfg.model)
    jstate = jft.init_state(jax.random.PRNGKey(0), jmodel, jcfg,
                            ft_batch(loss=loss))._replace(params=jax_params)
    jstep = jft.make_finetune_step(jmodel, jcfg)
    out = []
    for s in range(steps):
        jstate, jm = jstep(jstate, ft_batch(seed=10 + s, loss=loss), key,
                           jnp.float32(LR))
        out.append((float(jm["loss"]), jax.device_get(jstate)))
    return out


def _run_port(pcfg, jax_params, steps, us=None, loss="BCE"):
    """The port's steps on the same batches, the routing draws ``us`` (or
    its own): ([(loss, params, Adam)], state)."""
    pstate = ft.init_state(pcfg, torch.Generator().manual_seed(0), "cpu")
    pstate.model.load_state_dict(params_from_jax(jax_params), strict=True)
    pstep = ft.make_finetune_step(pcfg)
    out = []
    for s in range(steps):
        batch = tuple(map(torch.from_numpy, ft_batch(seed=10 + s, loss=loss)))
        pstate, pm = pstep(pstate, batch, LR, None if us is None else us[s])
        out.append((float(pm["loss"]),
                    {n: p.detach().clone()
                     for n, p in pstate.model.named_parameters()},
                    _port_adam(pstate.model, pstate.opt)))
    return out, pstate


def _run_both(jcfg, pcfg, jax_params, steps, key, us=None, loss="BCE"):
    """``steps`` steps of both packages from the JAX initial parameters;
    the port takes the JAX step's routing draws ``us``. Returns [(JAX
    loss, port loss, JAX state, port params, port Adam)] and the port's
    state."""
    port, pstate = _run_port(pcfg, jax_params, steps, us, loss)
    return [(jl, pl, js, pp, pa) for (jl, js), (pl, pp, pa) in zip(
        _run_jax(jcfg, jax_params, steps, key, loss), port)], pstate


def _check_params(jparams, params, jparams0, params0, atol=1e-4):
    """Each parameter within ``atol`` of the JAX one's; one the JAX step
    left unchanged (from ``jparams0``) is unchanged bit for bit in the port
    (from ``params0``), one it moved has moved."""
    want = _jax_tree(jparams)
    jbefore = params_from_jax(jparams0)
    assert want.keys() == params.keys()
    n_moved = 0
    for name, w in want.items():
        got = params[name]
        assert float((got - w).abs().max()) <= atol, name
        if torch.equal(w, jbefore[name]):
            assert torch.equal(got, params0[name]), name
        else:
            assert not torch.equal(got, params0[name]), name
            n_moved += 1
    return n_moved


def _check_moments(jopt_mu, jopt_nu, adam, frac=1e-4):
    for which, tree, i in (("mu", jopt_mu, 0), ("nu", jopt_nu, 1)):
        for name, w in _jax_tree(tree).items():
            got = adam[name][i]
            scale = max(float(w.abs().max()), 1e-30)
            err = float((got - w).abs().max())
            assert err <= frac * scale, (which, name, err, scale)


@pytest.fixture(scope="module")
def mm_grad_run(jax_params):
    jcfg, pcfg = ft_configs(parity_optimizer=True)
    key, us = _route_keys()
    run, pstate = _run_both(jcfg, pcfg, jax_params, 3, key, us)
    return dict(run=run, us=us, branches=dict(pstate.branches))


def test_mm_grad_routes_each_branch_once(mm_grad_run):
    assert mm_grad_run["branches"] == dict.fromkeys(ft.BRANCHES, 1)
    assert [ft.route(u) for u in mm_grad_run["us"]] == [
        "av" if u > 0.5 else "a" if u < 0.25 else "v"
        for u in mm_grad_run["us"]]


@pytest.mark.parametrize("s", [0, 1, 2])
def test_mm_grad_step_matches_gated_adam(jax_params, mm_grad_run, s):
    """Step s: the loss, every parameter, both moments and every step
    count against the JAX step's gated Adam."""
    run = mm_grad_run["run"]
    jloss, ploss, jstate, params, adam = run[s]
    assert abs(ploss - jloss) <= 1e-5 * abs(jloss)
    if s == 0:
        jbefore, before = jax_params, params_from_jax(jax_params)
    else:
        jbefore, before = run[s - 1][2].params, run[s - 1][3]
    assert _check_params(jstate.params, params, jbefore, before) > 0
    _check_moments(jstate.opt.mu, jstate.opt.nu, adam)
    counts = params_from_jax(jax.device_get(jstate.opt.count))
    assert {n: c for n, (_, _, c) in adam.items()} == {
        n: int(c) for n, c in counts.items()}


def test_mm_grad_counts_follow_the_branches(mm_grad_run):
    """After one step of each branch a parameter's count is the number of
    branches that reach it: 3 for the shared trunk weights, 2 for the
    audio or the video route, 1 for a head or the fusion layers, 0 for the
    unused head and the shared norms."""
    adam = mm_grad_run["run"][-1][4]
    for name, (_, _, count) in adam.items():
        assert count == sum(pg.ft_touched(name, b) for b in ft.BRANCHES), name
    assert {c for *_, c in adam.values()} == {0, 1, 2, 3}


def test_route_draw_is_keyed_on_seed_and_step():
    us = [ft.draw_route(87, n) for n in range(64)]
    assert us == [ft.draw_route(87, n) for n in range(64)]
    assert us != [ft.draw_route(88, n) for n in range(64)]
    assert all(0.0 <= u < 1.0 for u in us)
    assert {ft.route(u) for u in us} == set(ft.BRANCHES)


# ----------------------------------------------------- outside 'mm_grad'
@pytest.mark.parametrize("ftmode,loss", [("audioonly", "BCE"),
                                         ("joint_av", "CE")])
def test_step_outside_mm_grad(jax_params, ftmode, loss):
    """A step of ``ftmode`` under ``loss``, with and without the parity
    optimizer: the port is JAX's plain Adam in every parameter, moment and
    count, the parameters the loss does not reach decayed as JAX decays
    them; the mode's train and eval outputs agree with JAX's within
    1e-5."""
    jcfg, _ = ft_configs(ftmode, loss, kernels=False)
    [(jloss, jstate)] = _run_jax(jcfg, jax_params, 1, jax.random.PRNGKey(0),
                                 loss)
    adam_state = jstate.opt[1]  # (add_decayed_weights, scale_by_adam)
    model = JaxModel(jcfg.model)
    inputs = [ft_batch(seed=20, frames=FRAMES if e else 1)[:2]
              for e in (False, True)]
    jouts = [jax.device_get(jax.jit(lambda p, a, v, e=e: model.apply(
        {"params": p}, a, v, ftmode, e))(jstate.params, *x))
        for e, x in zip((False, True), inputs)]
    init = params_from_jax(jax_params)
    for parity in (False, True):
        _, pcfg = ft_configs(ftmode, loss, parity_optimizer=parity)
        [(ploss, params, adam)], pstate = _run_port(pcfg, jax_params, 1,
                                                    loss=loss)
        assert pstate.branches == dict.fromkeys(ft.BRANCHES, 0)
        assert abs(ploss - jloss) <= 1e-5 * abs(jloss)
        counts = {n: c for n, (_, _, c) in adam.items()}
        _check_params(jstate.params, params, jax_params, init)
        _check_moments(adam_state.mu, adam_state.nu, adam)
        assert set(counts.values()) == {int(adam_state.count)}
        # the video head, which neither mode reads, moved on its weight
        # decay alone (its weights; its zero biases decay to nothing)
        head = [n for n in params if n.startswith("mlp_head.")]
        assert head and any(not torch.equal(params[n], init[n])
                            for n in head)
        for e, (a, v), jout in zip((False, True), inputs, jouts):
            with torch.no_grad():
                pout = pstate.model(torch.from_numpy(a), torch.from_numpy(v),
                                    ftmode, e)
            assert rel(pout, jout) <= 1e-5


def test_freeze_base(jax_params):
    """Base rate 0: after a step of each branch the trunk is bit for bit
    its start in both packages; the heads and fusion layers as JAX's."""
    jcfg, pcfg = ft_configs(kernels=False, freeze_base=True)
    key, us = _route_keys()
    run, _ = _run_both(jcfg, pcfg, jax_params, 3, key, us)
    jstate, params = run[-1][2:4]
    want = _jax_tree(jstate.params)
    init = params_from_jax(jax_params)
    for name, got in params.items():
        if pg.ft_group(name) == "base":
            assert torch.equal(got, init[name]), name
            assert torch.equal(want[name], init[name]), name
        else:
            assert float((got - want[name]).abs().max()) <= 1e-4, name
    assert any(not torch.equal(params[n], init[n]) for n in params
               if pg.ft_group(n) != "base")


def test_group_rates_follow_the_multipliers():
    """Each group reads its own rate tensor, lr times its multiplier,
    written in place; ``freeze_base`` makes the base rate 0."""
    for freeze in (False, True):
        _, pcfg = ft_configs(freeze_base=freeze)
        state = ft.init_state(pcfg, torch.Generator().manual_seed(0), "cpu")
        lrs = state.lrs
        state.set_lr(3e-4, pcfg)
        assert {k: float(t) for k, t in state.lrs.items()} == pytest.approx(
            {"base": 0.0 if freeze else 3e-4, "mlp": 3e-4 * HEAD_LR,
             "mm": 3e-4 * MM_LR})
        assert all(state.lrs[k] is t for k, t in lrs.items())
        groups = {g["name"]: {id(p) for p in g["params"]}
                  for g in state.opt.param_groups}
        for n, p in state.model.named_parameters():
            assert id(p) in groups[pg.ft_group(n)]


def test_eval_step_runs_the_test_mode(jax_params):
    """``make_ft_eval_step`` runs ``ftmode_test`` (else ``ftmode``) in its
    eval form, without a graph."""
    jcfg, pcfg = ft_configs(ftmode_test="audioonly")
    model = port_model(pcfg, jax_params)
    a, v, y = (torch.from_numpy(x) for x in ft_batch(frames=FRAMES))
    got = ft.make_ft_eval_step(pcfg)(model, (a, v, y))
    want = jax.device_get(jft.make_ft_eval_step(JaxModel(jcfg.model), jcfg)(
        jax_params, (a.numpy(), v.numpy(), y.numpy())))
    assert tuple(got.shape) == want.shape == (B, 1, CLASSES)
    assert not got.requires_grad
    assert rel(got, want) <= 1e-5
