"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false. The module imports no JAX, so it runs on a GPU host that has only
PyTorch; there, skip the JAX-importing ``tests/conftest.py``:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

Tolerance: max |kernel - plain| / max |plain| <= 2e-2. The kernels multiply
bf16 operands (an f32 call too) with f32 accumulation and store bf16 on the
bf16 path; the plain version runs in float32 on the same input values.
"""

import math

import pytest
import torch

from avsiam_tpu_torch import kernels
from avsiam_tpu_torch.ops import attention as pat
from avsiam_tpu_torch.ops import mlp as pmlp

pytestmark = pytest.mark.cuda
TOL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(got, want):
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("N,H,D,masked", [
    (512, 12, 64, False), (177, 12, 64, True), (708, 16, 32, False),
    (39, 12, 64, False), (708, 16, 32, True)])
def test_attention_kernels_match_plain_version(gen, dtype, N, H, D, masked):
    x = torch.randn((2, N, 3 * H * D), generator=gen, device="cuda").to(dtype)
    ct = torch.randn((2, N, H * D), generator=gen, device="cuda").to(dtype)
    kv = None
    if masked:
        kv = torch.rand((2, N), generator=gen, device="cuda") > 0.3
        kv[:, 0] = True
    before = dict(kernels.LAUNCHES)
    xk = x.clone().requires_grad_(True)
    out = pat.attention_qkv(xk, H, kv)
    out.backward(ct)
    assert kernels.LAUNCHES["attention_fwd"] == before["attention_fwd"] + 1
    assert kernels.LAUNCHES["attention_bwd"] == before["attention_bwd"] + 1
    xr = x.float().requires_grad_(True)
    ref = pat.attention_reference(xr, H, kv)
    ref.backward(ct.float())
    assert out.dtype == dtype and xk.grad.dtype == dtype
    assert _rel(out, ref) <= TOL
    assert _rel(xk.grad, xr.grad) <= TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("T,Dm", [(1024, 768), (37, 768), (5664, 512)])
def test_ln_mlp_kernel_matches_plain_version(gen, dtype, T, Dm):
    Hm = 4 * Dm

    def r(*shape, k=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * k

    x = r(T, Dm).to(dtype)
    w1 = r(Hm, Dm, k=Dm ** -0.5).bfloat16()
    w2 = r(Dm, Hm, k=Hm ** -0.5).bfloat16()
    b1, b2 = r(Hm, k=0.02).bfloat16().float(), r(Dm, k=0.02).bfloat16().float()
    lg, lb = 1.0 + r(Dm, k=0.1), r(Dm, k=0.1)
    out, hpre = pmlp.ln_mlp_fwd_kernel(x, lg, lb, w1, b1, w2, b2, 1e-5)
    ref, href = pmlp.ln_mlp_reference(x.float(), lg, lb, w1.float(), b1,
                                      w2.float(), b2, 1e-5)
    assert out.dtype == hpre.dtype == dtype
    assert _rel(out, ref) <= TOL
    assert _rel(hpre, href) <= TOL


def test_fused_ln_mlp_backward_on_the_card(gen):
    """The autograd Function's backward (PyTorch ops) through K3's saved
    hidden, bf16 on the card against float32 autograd of the plain version
    (gradient cosine >= 0.999 for every input)."""
    Dm, Hm = 768, 3072
    ps = [torch.randn((3, 50, Dm), generator=gen, device="cuda"),
          1.0 + 0.1 * torch.randn(Dm, generator=gen, device="cuda"),
          0.1 * torch.randn(Dm, generator=gen, device="cuda"),
          Dm ** -0.5 * torch.randn((Hm, Dm), generator=gen, device="cuda"),
          0.02 * torch.randn(Hm, generator=gen, device="cuda"),
          Hm ** -0.5 * torch.randn((Dm, Hm), generator=gen, device="cuda"),
          0.02 * torch.randn(Dm, generator=gen, device="cuda")]
    ct = torch.randn((3, 50, Dm), generator=gen, device="cuda")
    leaves = [p.clone().requires_grad_(True) for p in ps]
    out = pmlp.fused_ln_mlp(leaves[0].bfloat16(), *leaves[1:])
    out.backward(ct.bfloat16())
    ref_leaves = [p.clone().requires_grad_(True) for p in ps]
    x2 = ref_leaves[0].reshape(-1, Dm)
    ref, _ = pmlp.ln_mlp_reference(x2, *ref_leaves[1:], 1e-5)
    ref.reshape(3, 50, Dm).backward(ct)
    for got, want in zip(leaves, ref_leaves):
        cos = torch.nn.functional.cosine_similarity(
            got.grad.double().flatten(), want.grad.double().flatten(), dim=0)
        assert float(cos) >= 0.999


def test_two_pass_step_on_the_card(gen):
    """A depth-1 full-width bf16 step: finite metrics, and every kernel
    launched as often as the step's attention and MLP calls (9 each at
    batch 2: two contrastive chunks x 2 modalities, then 1 + 1 + 2 + 1)."""
    from avsiam_tpu_torch.configs import (CAVMAEConfig, DecoderConfig,
                                          PretrainConfig, ViTConfig)
    from avsiam_tpu_torch.train.pretrain import init_state, make_pretrain_step
    cfg = PretrainConfig(model=CAVMAEConfig(
        vit=ViTConfig(depth=1), decoder=DecoderConfig(depth=1),
        dtype=torch.bfloat16, mmixed_impl="exact"), batch_size=2)
    state = init_state(cfg, gen)
    a = torch.randn((2, 1024, 128), generator=gen, device="cuda")
    v = torch.randn((2, 3, 224, 224), generator=gen, device="cuda")
    kernels.reset_launches()
    state, metrics = make_pretrain_step(cfg)(state, (a, v), gen, 1e-4)
    assert all(math.isfinite(float(x)) for x in metrics.values()), metrics
    assert kernels.LAUNCHES == {"attention_fwd": 9, "attention_bwd": 9,
                                "ln_mlp_fwd": 9}
