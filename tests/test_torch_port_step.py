"""Port parity of the two-pass pretrain step (``train/pretrain.py``).

The port's ``make_pretrain_step`` is held against the JAX package's, over
one and two full steps, from the same weights (``params_from_jax``), batch
and draws (recorded from the JAX model under the step's own
``fold_in``/``split`` keys). Compared: the metrics, each pass's gradients,
and after each step every parameter and both Adams' moments. The JAX
gradients are the step's own: its ``_apply`` is wrapped (pytest monkeypatch)
to hand each gradient to the host, and one extra step at lr 0, which leaves
the parameters unchanged for pass 2, gives both passes' gradients at the
initial parameters, where the port's are taken.

The JAX side runs its XLA attention and dense MLP here: the step is about
the two passes, the touched sets and the optimizer, and the kernel paths are
held against the Pallas kernels in the attention, MLP and model tests. The
port runs its usual path (the plain versions on the CPU). One more step runs
with ``mlp_impl='fused'`` and ``dec_mlp_impl='fres'`` in both packages (the
JAX side's Pallas MLP kernels in interpret mode), under the same checks, and
so do two more: ``attn_impl='pallas'`` with ``mlp_impl='dense'`` at ViT dim
160 with 2 heads (D=80, the head-width of ViT-H: the JAX side's head-major
Pallas K5/K6 in interpret mode in the encoders, token-major K1/K2 in the
decoder), and the dim-128 geometry under ``AVSIAM_LN=pallas`` (JAX's
``LN_IMPL`` monkeypatched: the custom-VJP LayerNorm in both packages).

Tolerances (float32): metrics 1e-5 relative; gradients 1e-5 of each
tensor's largest value (measured 2.4e-6). Adam moments: 1e-5 of each
tensor's largest value where both frameworks took the gradient at the same
parameters (the first pass of the first step), 3e-3 elsewhere: pass 2 and
step 2 see parameters that already differ by the Adam-amplified noise
described next (measured 8e-4). Parameters: Adam's update is about
lr * g / (|g| + eps), so an element whose gradient is near zero (down to
pure rounding noise, as for the key bias, whose exact gradient is 0) moves
by an amount set by that noise, up to lr either way. So every element must
agree within 2 lr per step, at most 0.5% of them may differ by more than
1e-3 lr + 1e-6, and at most 0.05% by more than 0.1 lr (measured: 0.17% and
0.009% after two steps). A pass-1 gradient leaking into pass 2 breaks the
last bound on the whole vit trunk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avsiam_tpu.ops.layernorm as jlayernorm
import avsiam_tpu.train.pretrain as jpretrain
from avsiam_tpu import configs as jc
from avsiam_tpu.models import CAVMAEPretrain as JaxModel
from avsiam_tpu.train.pretrain import init_state as jax_init_state
from avsiam_tpu.train.pretrain import make_pretrain_step as jax_step_fn
from avsiam_tpu_torch import configs as pc
from avsiam_tpu_torch.train.pretrain import init_state, make_pretrain_step
from avsiam_tpu_torch.utils.weights import params_from_jax
from test_torch_port_common import array_leaves, batch, configs, record_draws

B, LR = 6, 1e-3
_JAX_APPLY = jpretrain._apply


def _run(jax_mlp, port_mlp, n_steps, vit=None, ln_pallas=False,
         batches=None):
    """``n_steps`` steps of both packages, with every intermediate the
    tests read; ``jax_mlp`` and ``port_mlp`` set each model's impls (the JAX
    side's attention is 'xla' unless they say otherwise), ``vit`` overrides
    ViT fields, ``ln_pallas`` sets ``AVSIAM_LN=pallas`` for both.
    ``batches`` ((audio, frames) of the JAX step, the same of the port's, as
    float32 numpy) replaces the shared random batch."""
    mp = pytest.MonkeyPatch()
    if ln_pallas:
        mp.setattr(jlayernorm, "LN_IMPL", "pallas")
        mp.setenv("AVSIAM_LN", "pallas")
    try:
        return _run_steps(mp, jax_mlp, port_mlp, n_steps, vit, batches)
    finally:
        mp.undo()


def _run_steps(mp, jax_mlp, port_mlp, n_steps, vit, batches=None):
    jcfg, pcfg = configs(batch=B, lr=LR, vit=vit)
    jcfg = jc.replace(jcfg, model=jc.replace(
        jcfg.model, **dict(dict(attn_impl="xla"), **jax_mlp)))
    pcfg = pc.replace(pcfg, model=pc.replace(pcfg.model, **port_mlp))
    model = JaxModel(jcfg.model)
    # the initial state and the draws depend on the geometry and the keys
    # alone: both come from the model under XLA attention, which compiles
    # faster than the Pallas kernels in interpret mode, and each is made once
    # per geometry
    draw_model = JaxModel(jc.replace(jcfg.model, attn_impl="xla"))
    geometry = repr(draw_model)
    a, v = batch(B, seed=1)
    if geometry not in _STATE0:
        _STATE0[geometry] = jax.device_get(jax_init_state(
            jax.random.PRNGKey(0), draw_model, jcfg, (a, v)))
    state0 = _STATE0[geometry]
    params0 = state0.params
    pstate = init_state(pcfg, device="cpu")
    pstate.model.load_state_dict(params_from_jax(params0), strict=True)
    seen = []
    mp.setattr(jpretrain, "_apply", _apply_handing_over_grads(seen))
    jstep = jax_step_fn(model, jcfg)
    pstep = make_pretrain_step(pcfg)
    step_rng = jax.random.PRNGKey(11)
    # the initial state and the draws above take the shared batch's shapes
    # alone; the steps take the given batches
    (ja, jv), (pa, pv) = batches if batches is not None else ((a, v), (a, v))
    at, vt = torch.from_numpy(pa), torch.from_numpy(pv)
    jstate = _fresh(state0)
    steps = []
    for s in range(n_steps):
        # the step's keys (avsiam_tpu/train/pretrain.py:79-80)
        k_mask1, k_perm1, k_mask2, k_perm2 = jax.random.split(
            jax.random.fold_in(step_rng, s), 4)
        keys1 = {"mask": k_mask1, "perm": k_perm1}
        keys2 = {"mask": k_mask2, "perm": k_perm2}
        if (geometry, s) not in _DRAWS:
            _DRAWS[geometry, s] = tuple(
                record_draws(mp, draw_model, params0, a, v, mae_w, con_w,
                             keys)[1]
                for mae_w, con_w, keys in ((0.0, 1.0, keys1),
                                           (1.0, 0.0, keys2)))
        draws = _DRAWS[geometry, s]
        if s == 0:
            # a JAX step at lr 0 leaves the parameters as they are for its
            # second pass: it hands over each pass's gradient at params0
            # without compiling anything beyond the step itself
            jstep(_fresh(state0), (ja, jv), step_rng, jnp.float32(0.0))
            jax.effects_barrier()
            grads = list(zip(seen[-1], _port_grads(pstate.model, pa, pv,
                                                   draws)))
        jstate, jm = jstep(jstate, (ja, jv), step_rng, jnp.float32(LR))
        pstate, pm = pstep(pstate, (at, vt), None, LR, draws=draws)
        steps.append(dict(jax_metrics=jax.device_get(jm), metrics=pm,
                          jax_params=params_from_jax(jax.device_get(jstate.params)),
                          params={k: t.detach().clone() for k, t in
                                  pstate.model.state_dict().items()},
                          jax_opt=[_moments(o) for o in (jstate.opt1,
                                                         jstate.opt2)],
                          opt=[_port_moments(pstate.model, o) for o in
                               (pstate.opt1, pstate.opt2)]))
    return dict(steps=steps, grads=grads, params0=params_from_jax(params0))


# per geometry: the JAX package's initial state (host copies) and each
# step's draws
_STATE0, _DRAWS = {}, {}


def _fresh(state):
    """Device copies of a host state: the JAX step donates its state."""
    return jax.tree_util.tree_map(jnp.asarray, state)


def _apply_handing_over_grads(seen):
    """The JAX step's ``_apply`` (avsiam_tpu/train/pretrain.py), which also
    hands the gradient it applies to the host: every execution of the step
    appends [pass-1 gradients, pass-2 gradients] to ``seen``. The step traces
    it twice, pass 1 first."""
    traced = []

    def apply(tx, grads, opt_state, params, lr):
        first = len(traced) % 2 == 0
        traced.append(first)

        def hand_over(g, first=first):
            if first:
                seen.append([])
            seen[-1].append(params_from_jax(
                jax.tree_util.tree_map(np.asarray, g)))

        jax.debug.callback(hand_over, grads, ordered=True)
        return _JAX_APPLY(tx, grads, opt_state, params, lr)

    return apply


@pytest.fixture(scope="module")
def run():
    """Two steps: the JAX package's dense MLP against the port's 'lnfres'."""
    return _run(dict(mlp_impl="dense"), {}, n_steps=2)


@pytest.fixture(scope="module")
def run_fused():
    """One step with ``mlp_impl='fused'`` (encoders and ``mm_layer_1/2``)
    and ``dec_mlp_impl='fres'`` in both packages: the Pallas K4 and K7 in
    interpret mode against the port's plain versions."""
    impls = dict(mlp_impl="fused", dec_mlp_impl="fres")
    return _run(impls, impls, n_steps=1)


@pytest.fixture(scope="module")
def run_head_major():
    """One step with ``attn_impl='pallas'`` and ``mlp_impl='dense'`` in both
    packages at ViT dim 160, 2 heads (D=80): head-major attention in the
    encoders and ``mm_layer_1/2``."""
    impls = dict(attn_impl="pallas", mlp_impl="dense")
    return _run(impls, impls, n_steps=1, vit=dict(dim=160))


@pytest.fixture(scope="module")
def run_ln_pallas():
    """One step of the first fixture's configuration under
    ``AVSIAM_LN=pallas``."""
    return _run(dict(mlp_impl="dense"), {}, n_steps=1, ln_pallas=True)


def _port_grads(port, a, v, draws):
    """The port's gradient of each pass at its current (initial) parameters,
    from the draws the JAX step made."""
    out = []
    for (mae_w, con_w), d in zip(((0.0, 1.0), (1.0, 0.0)), draws):
        port.zero_grad(set_to_none=True)
        port(torch.from_numpy(a), torch.from_numpy(v), mae_loss_weight=mae_w,
             contrast_loss_weight=con_w, draws=d)[0].backward()
        out.append({n: p.grad.clone() for n, p in port.named_parameters()
                    if p.grad is not None})
        port.zero_grad(set_to_none=True)
    return out


def _moments(opt_state):
    adam = opt_state.inner_state[1]  # (add_decayed_weights, scale_by_adam)
    return (params_from_jax(array_leaves(jax.device_get(adam.mu))),
            params_from_jax(array_leaves(jax.device_get(adam.nu))))


def _port_moments(model, opt):
    names = {id(p): n for n, p in model.named_parameters()}
    mu, nu = {}, {}
    for p, st in opt.state.items():
        mu[names[id(p)]] = st["exp_avg"].clone()
        nu[names[id(p)]] = st["exp_avg_sq"].clone()
    return mu, nu


def _close_to_scale(got, want, frac, name):
    scale = max(float(want.abs().max()), 1e-12)
    err = float((got - want).abs().max())
    assert err <= frac * scale, f"{name}: max err {err:.3e} vs scale {scale:.3e}"


def _check_metrics(st):
    for k, want in st["jax_metrics"].items():
        np.testing.assert_allclose(float(st["metrics"][k]), float(want),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def _check_pass_gradients(jg, pg):
    n_nonzero = 0
    for name, want in jg.items():
        if name not in pg:  # untouched by this pass: JAX's gradient is zero
            assert float(want.abs().max()) == 0.0, name
            continue
        _close_to_scale(pg[name], want, 1e-5, name)
        n_nonzero += 1
    assert n_nonzero > 0


def _check_params(st, p0, s):
    n_loose = n_far = n_total = n_moved = 0
    for name, want in st["jax_params"].items():
        got = st["params"][name]
        diff = (got - want).abs()
        assert float(diff.max()) <= 2 * LR * (s + 1) + 1e-6, name
        n_loose += int((diff > 1e-3 * LR + 1e-6).sum())
        n_far += int((diff > 0.1 * LR).sum())
        n_total += diff.numel()
        n_moved += int(((want - p0[name]).abs() > 0.5 * LR).sum())
    assert n_loose <= 5e-3 * n_total, (n_loose, n_total)
    assert n_far <= 5e-4 * n_total, (n_far, n_total)
    assert n_moved > 0.5 * n_total  # the steps did move the parameters


def _check_adam_moments(st, s, opt):
    jmu, jnu = st["jax_opt"][opt]
    mu, nu = st["opt"][opt]
    assert set(mu) == set(jmu)  # the same touched set
    frac = 1e-5 if (s, opt) == (0, 0) else 3e-3
    for name in jmu:
        _close_to_scale(mu[name], jmu[name], frac, name)
        _close_to_scale(nu[name], jnu[name], frac, name)


@pytest.mark.parametrize("s", [0, 1], ids=["step1", "step2"])
def test_metrics_match_jax(run, s):
    _check_metrics(run["steps"][s])


@pytest.mark.parametrize("which", [0, 1], ids=["contrastive", "mae"])
def test_pass_gradients_match_jax(run, which):
    _check_pass_gradients(*run["grads"][which])


@pytest.mark.parametrize("s", [0, 1], ids=["step1", "step2"])
def test_params_match_jax(run, s):
    _check_params(run["steps"][s], run["params0"], s)


@pytest.mark.parametrize("s", [0, 1], ids=["step1", "step2"])
@pytest.mark.parametrize("opt", [0, 1], ids=["adam1", "adam2"])
def test_adam_moments_match_jax(run, s, opt):
    _check_adam_moments(run["steps"][s], s, opt)


CHECKS = ["metrics", "contrastive", "mae", "params", "adam1", "adam2"]


def _check_first_step(run, check):
    st = run["steps"][0]
    if check == "metrics":
        _check_metrics(st)
    elif check in ("contrastive", "mae"):
        _check_pass_gradients(*run["grads"][check == "mae"])
    elif check == "params":
        _check_params(st, run["params0"], 0)
    else:
        _check_adam_moments(st, 0, int(check[-1]) - 1)


@pytest.mark.parametrize("check", CHECKS)
def test_fused_fres_step_matches_jax(run_fused, check):
    """The step's checks above, under 'fused' encoders and a 'fres'
    decoder, with the same tolerances."""
    _check_first_step(run_fused, check)


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("case", ["head_major", "ln_pallas"])
def test_other_path_step_matches_jax(request, case, check):
    """The step's checks above, with the same tolerances, (a) at D=80 under
    ``attn_impl='pallas'`` (the ViT-H path's attention) and (b) under
    ``AVSIAM_LN=pallas`` (the LayerNorm custom VJP)."""
    _check_first_step(request.getfixturevalue(f"run_{case}"), check)
