"""The GELU-backward pass of the 'fres' and 'lnfres' backwards on the CPU.

On a CPU tensor ``mlp_gelu_bwd`` takes its plain version,
``mlp_gelu_bwd_reference``: here it is held bit for bit against the
composite that ``_saved_hidden_bwd`` ran before the pass became a kernel,
in every GELU form and both storage types, and so are the whole 'fres' and
'lnfres' backwards, which therefore compute on the CPU what they computed
before. The kernel itself runs only on a card
(``tests/test_torch_port_cuda.py``); here it refuses what it cannot run.
Small shapes: the module takes seconds.
"""

import pytest
import torch

from avsiam_tpu_torch import kernels
from avsiam_tpu_torch.ops import mlp as pmlp
from avsiam_tpu_torch.ops.gelu import (GELU_IMPLS, gelu_act_grad_f32,
                                       kernel_impl)
from avsiam_tpu_torch.ops.layernorm import layer_norm, layer_norm_vjp

T, D, H = 37, 128, 256
DTYPES = [torch.bfloat16, torch.float32]
DTYPE_IDS = ["bf16", "f32"]


def _old_saved_hidden_bwd(inp, w1, w2, hpre, do, gelu):
    """``_saved_hidden_bwd`` as it was, torch ops throughout (no group)."""
    dt = inp.dtype
    f32 = torch.float32
    act, grad = gelu_act_grad_f32(hpre.to(f32), kernel_impl(gelu))
    gh = (pmlp.mm_f32(do, w2) * grad).to(dt)
    return ((gh @ w1).to(dt), gh.T @ inp, gh.to(f32).sum(dim=0),
            do.T @ act.to(dt), do.to(f32).sum(dim=0))


def _operands(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, k=1.0):
        return (torch.randn(shape, generator=g) * k).to(dtype)

    return dict(x=r(T, D), w1=r(H, D, k=D ** -0.5), b1=r(H, k=0.1),
                w2=r(D, H, k=H ** -0.5), b2=r(D, k=0.1), do=r(T, D),
                hpre=r(T, H, k=2.0), ln_g=1.0 + 0.1 * r(D).float(),
                ln_b=0.1 * r(D).float())


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("gelu", GELU_IMPLS)
def test_plain_version_is_the_composite_it_replaces(gelu, dtype):
    """gh, act and db1 of the plain version are the bits the old composite
    gave, in every form ('erf' runs as 'ans')."""
    p = _operands(dtype)
    dh = pmlp.mm_f32(p["do"], p["w2"])
    gh, act, db1 = pmlp.mlp_gelu_bwd_reference(dh, p["hpre"], gelu)
    f32 = torch.float32
    wact, grad = gelu_act_grad_f32(p["hpre"].to(f32), kernel_impl(gelu))
    wgh = (dh * grad).to(dtype)
    assert gh.dtype == act.dtype == dtype and db1.dtype == f32
    assert torch.equal(gh, wgh)
    assert torch.equal(act, wact.to(dtype))
    assert torch.equal(db1, wgh.to(f32).sum(dim=0))


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("gelu", GELU_IMPLS)
def test_saved_hidden_backward_on_the_cpu_is_unchanged(gelu, dtype):
    """``_saved_hidden_bwd`` on CPU tensors gives the old composite's five
    gradients bit for bit."""
    p = _operands(dtype, seed=1)
    args = (p["x"], p["w1"], p["w2"], p["hpre"], p["do"], gelu)
    for got, want in zip(pmlp._saved_hidden_bwd(*args),
                         _old_saved_hidden_bwd(*args)):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


@pytest.mark.parametrize("form", ["fres", "lnfres"])
def test_fres_and_lnfres_backwards_on_the_cpu_are_unchanged(form):
    """The autograd Functions' bf16 gradients on the CPU are those of the
    old composites: for 'lnfres' LN recomputed by ``layer_norm``, the old
    saved-hidden backward, ``layer_norm_vjp`` and the residual's cotangent;
    and no kernel is launched."""
    bf16, f32 = torch.bfloat16, torch.float32
    p = _operands(bf16, seed=2)
    names = ("w1", "b1", "w2", "b2")
    if form == "lnfres":
        names = ("ln_g", "ln_b") + names
    leaves = {n: p[n].clone().requires_grad_(True) for n in ("x",) + names}
    kernels.reset_launches()
    if form == "fres":
        out = pmlp.fused_mlp(*(leaves[n] for n in ("x",) + names),
                             impl="fres")
    else:
        out = pmlp.fused_ln_mlp(*(leaves[n] for n in ("x",) + names))
    out.backward(p["do"])
    assert not any(kernels.LAUNCHES.values())
    # the forward's saved hidden, then the old backward by hand
    if form == "fres":
        _, hpre = pmlp.mlp_fwd_reference(p["x"], p["w1"], p["b1"], p["w2"],
                                         p["b2"], save_hpre=True)
        dx, dw1, db1, dw2, db2 = _old_saved_hidden_bwd(
            p["x"], p["w1"], p["w2"], hpre, p["do"], "erf")
        want = dict(x=dx)
    else:
        _, hpre = pmlp.ln_mlp_reference(p["x"], p["ln_g"], p["ln_b"],
                                        p["w1"], p["b1"], p["w2"], p["b2"],
                                        1e-5)
        n = layer_norm(p["x"], p["ln_g"], p["ln_b"], 1e-5)
        dn, dw1, db1, dw2, db2 = _old_saved_hidden_bwd(
            n, p["w1"], p["w2"], hpre, p["do"], "erf")
        dx_ln, dg, dbl = layer_norm_vjp(p["x"], p["ln_g"], dn, 1e-5)
        want = dict(x=p["do"] + dx_ln, ln_g=dg, ln_b=dbl)
    want.update(w1=dw1, b1=db1.to(bf16), w2=dw2, b2=db2.to(bf16))
    for n, w in want.items():
        got = leaves[n].grad
        assert torch.equal(got, w.to(got.dtype)), n
    assert leaves["x"].grad.dtype == bf16 and db1.dtype == f32


def test_a_cpu_tensor_takes_the_plain_version():
    """``mlp_gelu_bwd`` on CPU tensors is the plain version, and launches
    nothing."""
    p = _operands(torch.bfloat16, seed=3)
    dh = pmlp.mm_f32(p["do"], p["w2"])
    kernels.reset_launches()
    got = pmlp.mlp_gelu_bwd(dh, p["hpre"], "tanh")
    assert not any(kernels.LAUNCHES.values())
    for g, w in zip(got, pmlp.mlp_gelu_bwd_reference(dh, p["hpre"], "tanh")):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dh,hpre", [
    (torch.zeros(T, H), torch.zeros(T, H, dtype=torch.bfloat16)),
    (torch.zeros(T, 130, device="meta"),
     torch.zeros(T, 130, device="meta", dtype=torch.bfloat16)),
    (torch.zeros(T, H, device="meta", dtype=torch.bfloat16),
     torch.zeros(T, H, device="meta", dtype=torch.bfloat16)),
    (torch.zeros(T, H, device="meta"),
     torch.zeros(T, H, device="meta", dtype=torch.float16)),
    (torch.zeros(T, H, device="meta"),
     torch.zeros(T, 2 * H, device="meta", dtype=torch.bfloat16))],
    ids=["cpu", "H%4", "bf16-dh", "fp16-hpre", "shapes"])
def test_kernel_refuses_what_it_cannot_run(dh, hpre):
    """The kernel's wrapper raises on a CPU tensor, H not a multiple of 4, a
    dh not float32, a hidden of another dtype or shape, before it builds
    or launches anything."""
    with pytest.raises(ValueError, match="GELU backward kernel"):
        pmlp.mlp_gelu_bwd_kernel(dh, hpre)
