"""Port parity of the two-pass pretrain step (``train/pretrain.py``).

The port's ``make_pretrain_step`` is held against the JAX package's, over
one and two full steps, from the same weights (``params_from_jax``), batch
and draws (recorded from the JAX model under the step's own
``fold_in``/``split`` keys). Compared: the metrics, each pass's gradients,
and after each step every parameter and both Adams' moments.

The JAX side runs its XLA attention and dense MLP here: the step is about
the two passes, the touched sets and the optimizer, and the kernel paths are
held against the Pallas kernels in the attention, MLP and model tests. The
port runs its usual path (the plain versions on the CPU). One more step runs
with ``mlp_impl='fused'`` and ``dec_mlp_impl='fres'`` in both packages (the
JAX side's Pallas MLP kernels in interpret mode), under the same checks.

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

from avsiam_tpu import configs as jc
from avsiam_tpu.models import CAVMAEPretrain as JaxModel
from avsiam_tpu.train.pretrain import init_state as jax_init_state
from avsiam_tpu.train.pretrain import make_pretrain_step as jax_step_fn
from avsiam_tpu_torch import configs as pc
from avsiam_tpu_torch.train.pretrain import init_state, make_pretrain_step
from avsiam_tpu_torch.utils.weights import params_from_jax
from test_torch_port_common import array_leaves, batch, configs, record_draws

B, LR = 6, 1e-3


def _run(jax_mlp, port_mlp, n_steps):
    """``n_steps`` steps of both packages, with every intermediate the
    tests read; ``jax_mlp`` and ``port_mlp`` set each model's MLP impls."""
    jcfg, pcfg = configs(batch=B, lr=LR)
    jcfg = jc.replace(jcfg, model=jc.replace(jcfg.model, attn_impl="xla",
                                             **jax_mlp))
    pcfg = pc.replace(pcfg, model=pc.replace(pcfg.model, **port_mlp))
    model = JaxModel(jcfg.model)
    a, v = batch(B, seed=1)
    jstate = jax_init_state(jax.random.PRNGKey(0), model, jcfg, (a, v))
    params0 = jax.device_get(jstate.params)
    pstate = init_state(pcfg, device="cpu")
    pstate.model.load_state_dict(params_from_jax(params0), strict=True)
    jstep = jax_step_fn(model, jcfg)
    pstep = make_pretrain_step(pcfg)
    step_rng = jax.random.PRNGKey(11)
    at, vt = torch.from_numpy(a), torch.from_numpy(v)
    mp = pytest.MonkeyPatch()
    steps = []
    for s in range(n_steps):
        # the step's keys (avsiam_tpu/train/pretrain.py:79-80)
        k_mask1, k_perm1, k_mask2, k_perm2 = jax.random.split(
            jax.random.fold_in(step_rng, s), 4)
        keys1 = {"mask": k_mask1, "perm": k_perm1}
        keys2 = {"mask": k_mask2, "perm": k_perm2}
        _, d1 = record_draws(mp, model, params0, a, v, 0.0, 1.0, keys1)
        _, d2 = record_draws(mp, model, params0, a, v, 1.0, 0.0, keys2)
        if s == 0:
            grads = _first_step_grads(model, pstate.model, params0, a, v,
                                      (keys1, keys2), (d1, d2))
        jstate, jm = jstep(jstate, (a, v), step_rng, jnp.float32(LR))
        pstate, pm = pstep(pstate, (at, vt), None, LR, draws=(d1, d2))
        steps.append(dict(jax_metrics=jax.device_get(jm), metrics=pm,
                          jax_params=params_from_jax(jax.device_get(jstate.params)),
                          params={k: t.detach().clone() for k, t in
                                  pstate.model.state_dict().items()},
                          jax_opt=[_moments(o) for o in (jstate.opt1,
                                                         jstate.opt2)],
                          opt=[_port_moments(pstate.model, o) for o in
                               (pstate.opt1, pstate.opt2)]))
    return dict(steps=steps, grads=grads, params0=params_from_jax(params0))


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


def _first_step_grads(model, port, params0, a, v, keys, draws):
    """Each pass's gradient at the initial parameters, JAX and port."""
    out = []
    for (mae_w, con_w), k, d in zip(((0.0, 1.0), (1.0, 0.0)), keys, draws):
        def loss(p, k=k, mae_w=mae_w, con_w=con_w):
            return model.apply({"params": p}, a, v, mae_loss_weight=mae_w,
                               contrast_loss_weight=con_w, rngs=k)[0]
        jg = params_from_jax(jax.device_get(jax.jit(jax.grad(loss))(params0)))
        port.zero_grad(set_to_none=True)
        port(torch.from_numpy(a), torch.from_numpy(v), mae_loss_weight=mae_w,
             contrast_loss_weight=con_w, draws=d)[0].backward()
        pg = {n: p.grad.clone() for n, p in port.named_parameters()
              if p.grad is not None}
        port.zero_grad(set_to_none=True)
        out.append((jg, pg))
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


@pytest.mark.parametrize("check", ["metrics", "contrastive", "mae", "params",
                                   "adam1", "adam2"])
def test_fused_fres_step_matches_jax(run_fused, check):
    """The step's checks above, under 'fused' encoders and a 'fres'
    decoder, with the same tolerances."""
    st = run_fused["steps"][0]
    if check == "metrics":
        _check_metrics(st)
    elif check in ("contrastive", "mae"):
        _check_pass_gradients(*run_fused["grads"][check == "mae"])
    elif check == "params":
        _check_params(st, run_fused["params0"], 0)
    else:
        _check_adam_moments(st, 0, int(check[-1]) - 1)
