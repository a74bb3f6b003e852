"""Port parity of ``fused_ln_mlp`` (kernel K3 on the GPU) and its backward.

On the CPU the port's forward is its plain version, and its backward the
same PyTorch ops the GPU path uses; both are held here against the JAX
package's 'lnfres' path (the Pallas ``_lnfwd_call`` in interpret mode plus
its custom VJP), forward and the gradients of all seven inputs, in float32.
The kernel itself runs only on a card: ``tests/test_torch_port_cuda.py``
and ``python3 chip_smoke.py`` hold it against the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsiam_tpu.ops.mlp import _lnfwd_call
from avsiam_tpu.ops.mlp import fused_ln_mlp as jax_fused_ln_mlp
from avsiam_tpu_torch import kernels
from avsiam_tpu_torch.ops import mlp as pmlp

D, H = 128, 512


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    f = lambda *s, k=1.0: (rs.randn(*s) * k).astype(np.float32)  # noqa: E731
    return dict(x=f(*shape, D), g=1.0 + f(D, k=0.1), bl=f(D, k=0.1),
                w1=f(D, H, k=D ** -0.5), b1=f(H, k=0.1),
                w2=f(H, D, k=H ** -0.5), b2=f(D, k=0.1),
                ct=f(*shape, D))


@pytest.mark.parametrize("shape", [(2, 37), (3, 25), (300,)])
def test_fused_ln_mlp_matches_jax_pallas(shape):
    """Forward to 1e-5, gradients of x, LN scale/bias, w1, b1, w2, b2 to
    1e-4 (float32; summation order differs)."""
    p = _inputs(shape, seed=sum(shape))
    names = ("x", "g", "bl", "w1", "b1", "w2", "b2")

    def jloss(x, g, bl, w1, b1, w2, b2):
        out = jax_fused_ln_mlp(x, g, bl, w1, b1, w2, b2, eps=1e-5, gelu="erf")
        return jnp.sum(out * p["ct"]), out

    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(7)), has_aux=True)(
            *(jnp.asarray(p[n]) for n in names))
    # the port keeps nn.Linear's [out, in] weight layout
    leaves = {n: torch.from_numpy(np.ascontiguousarray(
        p[n].T if n in ("w1", "w2") else p[n])).requires_grad_(True)
        for n in names}
    out = pmlp.fused_ln_mlp(*(leaves[n] for n in names), eps=1e-5,
                            gelu="erf")
    (out * torch.from_numpy(p["ct"])).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for n, jg in zip(names, jgrads):
        g = leaves[n].grad.numpy()
        g = g.T if n in ("w1", "w2") else g
        np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-4, atol=1e-4,
                                   err_msg=n)


def test_plain_version_emits_the_kernels_pre_gelu_hidden():
    """The saved residual: the pre-GELU hidden of the plain version equals
    the Pallas kernel's (to 1e-5), and so does the output."""
    p = _inputs((40,), seed=3)
    jo, jh = _lnfwd_call(p["x"], p["g"][None], p["bl"][None], p["w1"],
                         p["b1"][None], p["w2"], p["b2"][None], 1e-5, "erf")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    o, h = pmlp.ln_mlp_reference(t(p["x"]), t(p["g"]), t(p["bl"]),
                                 t(p["w1"].T), t(p["b1"]), t(p["w2"].T),
                                 t(p["b2"]), 1e-5, "erf")
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    before = dict(kernels.LAUNCHES)
    p = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in _inputs((5,), seed=1).items()}
    out = pmlp.fused_ln_mlp(p["x"], p["g"], p["bl"], p["w1"].T, p["b1"],
                            p["w2"].T, p["b2"])
    ref, _ = pmlp.ln_mlp_reference(p["x"], p["g"], p["bl"], p["w1"].T,
                                   p["b1"], p["w2"].T, p["b2"], 1e-5)
    assert torch.equal(out, ref)
    assert kernels.LAUNCHES == before


def test_non_cpu_tensor_never_takes_the_plain_version():
    x = torch.empty((4, D), device="meta")
    w1, w2 = torch.empty((H, D), device="meta"), torch.empty((D, H), device="meta")
    v = lambda n: torch.empty((n,), device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        pmlp.fused_ln_mlp(x, v(D), v(D), w1, v(H), w2, v(D))
