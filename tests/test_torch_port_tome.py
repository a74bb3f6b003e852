"""Port parity of ToMe token merging (``models/tome.py``) and of the
``r > 0`` branch of ``ModalityBlock`` (``models/layers.py``).

Both packages run on the CPU in float32 on seeded numpy inputs.

- ``bipartite_soft_matching``: the assignment and the keep mask equal to
  JAX's exactly, at even and odd N; r = 0 the identity; r above the size
  of set A clamped to it; a metric whose tokens repeat (every similarity
  tied, exactly: entries of +-1 normalise to +-1/4) gives JAX's plan, which
  only stable sorts and a first-index argmax give.
- ``merge_wavg``: within 1e-6 of JAX's, sizes too; the token mass
  (sum of size * x) kept.
- The block with r > 0 (``ModalityBlock.forward(x, modality, key_valid,
  r)``) against JAX's ``ModalityBlock.apply(..., r)`` at D 128, 2 heads:
  the output within rtol 1e-5, atol 1e-5, the keep mask exactly; the
  metric (the keys' mean over the heads) against JAX's ``Attention(...,
  tome=True)``; each modality routing; the block's gradients.

The metric's head mean under tensor parallelism (a data 1 x model 2 gloo
world) is held in ``test_torch_port_tp.py``, whose launched worlds it
shares.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsiam_tpu.models import tome as jtome
from avsiam_tpu.models.layers import ModalityBlock as JaxBlock
from avsiam_tpu_torch.models import tome
from avsiam_tpu_torch.models.layers import ModalityBlock
from avsiam_tpu_torch.utils.weights import params_from_jax
from test_torch_port_common import array_leaves, to_np

DIM, HEADS = 128, 2


def _plans(metric, r):
    want = jax.device_get(jtome.bipartite_soft_matching(jnp.asarray(metric),
                                                        r))
    got = tome.bipartite_soft_matching(torch.from_numpy(metric), r)
    return got, want


@pytest.mark.parametrize("B,N,D,r", [(2, 16, 8, 4), (3, 17, 8, 9),
                                     (2, 196, 64, 16), (2, 512, 64, 64)])
def test_plan_and_merge_match_jax(B, N, D, r):
    """assign and keep exactly JAX's; the merged tokens and sizes within
    1e-6; exactly r slots dropped a sample; the token mass kept."""
    rs = np.random.RandomState(N)
    metric = rs.randn(B, N, D).astype(np.float32)
    x = rs.randn(B, N, D).astype(np.float32)
    (assign, keep), (ja, jk) = _plans(metric, r)
    np.testing.assert_array_equal(to_np(assign), ja)
    np.testing.assert_array_equal(to_np(keep), jk)
    assert (~keep).sum(dim=1).tolist() == [r] * B
    merged, size = tome.merge_wavg(assign, torch.from_numpy(x))
    jm, js = jax.device_get(jtome.merge_wavg(ja, jnp.asarray(x)))
    np.testing.assert_allclose(to_np(merged), jm, rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_np(size), js, rtol=0, atol=1e-6)
    mass = (merged * size * keep[..., None]).sum(dim=1)
    np.testing.assert_allclose(to_np(mass), x.sum(axis=1), rtol=1e-5,
                               atol=1e-5)


def test_r0_is_the_identity():
    rs = np.random.RandomState(1)
    metric = rs.randn(2, 8, 4).astype(np.float32)
    x = torch.from_numpy(rs.randn(2, 8, 4).astype(np.float32))
    assign, keep = tome.bipartite_soft_matching(torch.from_numpy(metric), 0)
    assert bool(keep.all())
    assert torch.equal(assign, torch.eye(8).expand(2, 8, 8))
    merged, size = tome.merge_wavg(assign, x)
    assert torch.equal(merged, x) and bool((size == 1).all())


@pytest.mark.parametrize("N", [9, 10])
def test_r_is_clamped_to_set_a(N):
    """r beyond ceil(N / 2) merges every A token, as JAX's clamp does."""
    metric = np.random.RandomState(2).randn(2, N, 8).astype(np.float32)
    (assign, keep), (ja, jk) = _plans(metric, 100)
    np.testing.assert_array_equal(to_np(assign), ja)
    np.testing.assert_array_equal(to_np(keep), jk)
    assert (~keep).sum(dim=1).tolist() == [(N + 1) // 2] * 2


@pytest.mark.parametrize("r", [1, 3, 5, 8])
def test_ties_take_the_jax_plan(r):
    """Tokens repeated four times: every A token's best similarity is 1
    exactly, so the plan is the order the sorts keep among ties."""
    rs = np.random.RandomState(3)
    metric = np.repeat(np.sign(rs.randn(2, 4, 16)), 4, axis=1)
    metric = metric.astype(np.float32)
    (assign, keep), (ja, jk) = _plans(metric, r)
    np.testing.assert_array_equal(to_np(assign), ja)
    np.testing.assert_array_equal(to_np(keep), jk)


def test_merge_keeps_the_dtype():
    """bf16 tokens stay bf16 through the merge (sizes made in x's dtype),
    so that a block's fused MLP residual takes them as they are."""
    x = torch.randn(2, 12, 8, dtype=torch.bfloat16)
    assign, _ = tome.bipartite_soft_matching(x, 4)
    merged, size = tome.merge_wavg(assign, x)
    assert merged.dtype == size.dtype == torch.bfloat16


# ------------------------------------------------------------------ block
def _scaled_err(got, want):
    """max |got - want| over max |want| (0 where both are zeros)."""
    return float(np.abs(to_np(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def block():
    """(JAX params, every norm set's included; the port's block with
    them; x [2, 24, 128])."""
    rs = np.random.RandomState(4)
    x = rs.randn(2, 24, DIM).astype(np.float32)
    params = jax.device_get(JaxBlock(DIM, HEADS).init(
        jax.random.PRNGKey(0), x, method=lambda m, x: [
            m(x, mod) for mod in (None, "a", "v")]))["params"]
    blk = ModalityBlock(DIM, HEADS, 4.0, True, 1e-5, torch.float32, "auto",
                        "erf", "dense", "cpu")
    blk.load_state_dict(params_from_jax(params), strict=True)
    return params, blk, x


@pytest.mark.parametrize("r", [0, 4, 12])
@pytest.mark.parametrize("modality", [None, "a", "v"])
def test_block_tome_path_matches_jax(block, modality, r):
    """The block's output within rtol 1e-5, atol 1e-5 of JAX's
    ``ModalityBlock.apply(x, modality, None, r)``, and with r > 0 the keep
    mask exactly JAX's."""
    params, blk, x = block
    want = jax.device_get(JaxBlock(DIM, HEADS).apply(
        {"params": params}, x, modality, None, r))
    with torch.no_grad():
        got = blk(torch.from_numpy(x), modality, None, r)
    if r == 0:
        got, want = (got,), (want,)
    else:
        np.testing.assert_array_equal(to_np(got[1]), want[1])
        assert (~got[1]).sum(dim=1).tolist() == [r] * 2
    np.testing.assert_allclose(to_np(got[0]), want[0], rtol=1e-5, atol=1e-5)


def test_metric_matches_jax(block):
    """``Attention(..., tome=True)``: the output and the keys' mean over
    the heads within 1e-5 of JAX's; the metric carries no gradient."""
    params, blk, x = block
    n1 = np.array(jax.device_get(JaxBlock(DIM, HEADS).apply(
        {"params": params}, x, method=lambda m, x: m.norm1(x))))
    want = jax.device_get(JaxBlock(DIM, HEADS).apply(
        {"params": params}, n1, method=lambda m, x: m.attn(x, tome=True)))
    xt = torch.from_numpy(n1).requires_grad_()
    out, metric = blk.attn(xt, None, tome=True)
    assert not metric.requires_grad and out.requires_grad
    for g, w in zip((out, metric), want, strict=True):
        np.testing.assert_allclose(to_np(g), w, rtol=1e-5, atol=1e-5)


def test_block_tome_gradients_match_jax(block):
    """Every parameter's gradient, and x's, of sum(out^2) over the kept
    slots within 1e-5 of the tensor's largest |value| in JAX's (the
    gradients reach 20, whose float32 sums over 24 tokens round at about
    1e-6 of that)."""
    params, blk, x = block
    r = 6

    def jloss(p, x):
        out, keep = JaxBlock(DIM, HEADS).apply({"params": p}, x, "a", None,
                                               r)
        return jnp.sum(jnp.where(keep[..., None], out, 0.0) ** 2)

    jg, jgx = jax.device_get(jax.grad(jloss, argnums=(0, 1))(params, x))
    blk.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x).requires_grad_()
    out, keep = blk(xt, "a", None, r)
    (out * keep[..., None]).pow(2).sum().backward()
    want = params_from_jax(array_leaves(jg))
    reached = 0
    for name, p in blk.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        assert _scaled_err(g, want[name].numpy()) <= 1e-5, name
        reached += p.grad is not None
    assert reached == 12  # qkv, proj, fc1, fc2, norm1_a, norm2_a: w and b
    assert _scaled_err(xt.grad, jgx) <= 1e-5


def test_remat_block_takes_r(block):
    """A rematerialised block passes r through its checkpoint: the same
    bits as the block without remat, forward and gradients."""
    params, _, x = block
    outs = []
    for remat in (False, True):
        blk = ModalityBlock(DIM, HEADS, 4.0, True, 1e-5, torch.float32,
                            "auto", "erf", "dense", "cpu", remat=remat)
        blk.load_state_dict(params_from_jax(params))
        xt = torch.from_numpy(x).requires_grad_()
        out, keep = blk(xt, "v", None, 5)
        out.sum().backward()
        outs.append((out.detach(), keep, xt.grad,
                     blk.attn.qkv.weight.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
