"""Port parity of ``attention_qkv`` (kernels K1/K2 on the GPU).

On the CPU the port runs its plain version, held here against the JAX
package's token-major Pallas kernels (``attn_impl='pallas'``, interpret mode
on the CPU), forward and gradient, in float32; and the saved statistics'
plain version against the statistics the JAX forward kernel writes. The kernels themselves run
only on a card: ``tests/test_torch_port_cuda.py`` and ``python3
chip_smoke.py`` hold them against the plain version there.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsiam_tpu.ops.attention import attention_qkv as jax_attention_qkv
from avsiam_tpu_torch import kernels
from avsiam_tpu_torch.ops import attention as pat

# the module (``avsiam_tpu.ops`` re-exports a function of the same name)
jatt = importlib.import_module("avsiam_tpu.ops.attention")

# (B, N, H, D, masked): ragged N (37, 25, 70 are not multiples of 16), the
# encoder's D=64 and the decoder's D=32, and key_valid masks
CASES = [(2, 37, 2, 64, False), (2, 25, 4, 32, True), (3, 64, 2, 64, False),
         (1, 70, 4, 32, False), (2, 49, 2, 64, True)]


def _inputs(B, N, H, D, masked):
    rs = np.random.RandomState(N * 10 + H)
    x = rs.randn(B, N, 3 * H * D).astype(np.float32)
    ct = rs.randn(B, N, H * D).astype(np.float32)
    kv = None
    if masked:
        kv = rs.rand(B, N) > 0.3
        kv[:, 0] = True
    return x, ct, kv


@pytest.mark.parametrize("B,N,H,D,masked", CASES)
def test_attention_qkv_matches_jax_pallas(B, N, H, D, masked):
    """Forward to 1e-5 and d(xqkv) to 1e-4 (float32; softmax summation
    order differs between the frameworks)."""
    x, ct, kv = _inputs(B, N, H, D, masked)
    jkv = None if kv is None else jnp.asarray(kv)

    def jloss(x):
        out = jax_attention_qkv(x, H, key_valid=jkv, impl="pallas")
        return jnp.sum(out * ct), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = pat.attention_qkv(xt, H, None if kv is None else torch.from_numpy(kv))
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-4)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    before = dict(kernels.LAUNCHES)
    x, _, kv = _inputs(2, 25, 4, 32, True)
    out = pat.attention_qkv(torch.from_numpy(x), 4, torch.from_numpy(kv))
    ref = pat.attention_reference(torch.from_numpy(x), 4, torch.from_numpy(kv))
    assert torch.equal(out, ref)
    assert kernels.LAUNCHES == before


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Off the CPU the wrapper goes to the kernel, which refuses a device it
    cannot run on rather than falling back."""
    x = torch.empty((2, 25, 384), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pat.attention_qkv(x, 4)
    with pytest.raises(ValueError, match="CUDA"):
        pat.attention_fwd_kernel(torch.zeros(2, 25, 384), 4)


@pytest.mark.parametrize("mask", ["none", "some", "one_sample_all"])
@pytest.mark.parametrize("H,D", [(4, 64), (8, 32)])
def test_saved_statistics_match_jax_pallas(H, D, mask):
    """The statistics contract that K1's forward, K2 and K6 share: each
    row's max m of s * scale + bias (natural units) and 1 / rowsum(exp(s *
    scale + bias - m)). The port's ``attention_hm_stats_reference`` on the
    [B, N, 3, H, D] views of a packed qkv, against the statistics the JAX
    ``_pallas_fwd_tm(save_stats=True)`` writes in interpret mode: packed
    [B, C / 128, N, 8], head g hp + i's max at lane i of column group g and
    its 1/denom at lane hp + i (hp = 128 / D heads a group). Float32 to
    1e-5; N = 48 is a multiple of float32's 8-row sublane, so JAX pads no
    row. A sample whose keys are all masked has m = -1e30 exactly in both
    and 1/denom 1/N."""
    B, N = 2, 48
    rs = np.random.RandomState(D + len(mask))
    x = rs.randn(B, N, 3 * H * D).astype(np.float32)
    kv = None
    if mask != "none":
        kv = rs.rand(B, N) > 0.3
        kv[:, 0] = True
        if mask == "one_sample_all":
            kv[1, :] = False
    bias = None if kv is None else jatt._bias_from_valid(jnp.asarray(kv), B,
                                                         N, N)
    _, jst = jatt._pallas_fwd_tm(jnp.asarray(x), bias, num_heads=H,
                                 save_stats=True)
    jst = np.asarray(jst)
    hp = 128 // D
    assert jst.shape == (B, H // hp, N, 8)
    # [B, G, N, hp] per column -> [B, H, N]
    jm, jr = (np.moveaxis(jst[..., lanes], -1, 2).reshape(B, H, N)
              for lanes in (slice(0, hp), slice(hp, 2 * hp)))
    q, k, _ = torch.from_numpy(x).view(B, N, 3, H, D).unbind(2)
    st = pat.attention_hm_stats_reference(
        q, k, None if kv is None else torch.from_numpy(kv)).numpy()
    np.testing.assert_allclose(st[..., 0], jm, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st[..., 1], jr, rtol=1e-5, atol=1e-6)
    if mask == "one_sample_all":
        assert (st[1, ..., 0] == np.float32(-1e30)).all()
        assert (jm[1] == np.float32(-1e30)).all()
        np.testing.assert_allclose(st[1, ..., 1], 1.0 / N, rtol=1e-6)
