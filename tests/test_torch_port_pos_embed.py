"""Port parity of the positional-embedding tables (``models/pos_embed.py``).

- The 2D sin-cos table bit for bit against JAX's at (2, 2) and at ViT-B's
  audio grid (8, 64), D 768, and with the CLS row.
- The nearest-neighbour token resample bit for bit (196 -> 512 as the
  reference's audio table is made, and shrinking).
- The 2D bicubic resize against ``jax.image.resize`` at 14 -> 16, 24, 8
  and (8, 64) within 1e-5 on unit-normal grids; and the trap it guards: the
  same call without ``antialias`` lies more than 0.1 off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from avsiam_tpu.models import pos_embed as jpe
from avsiam_tpu_torch.models import pos_embed as pe


@pytest.mark.parametrize("dim,gh,gw,cls", [(32, 2, 2, False),
                                           (32, 2, 2, True),
                                           (768, 8, 64, False),
                                           (768, 14, 14, True)])
def test_sincos_table_is_jax_bit_for_bit(dim, gh, gw, cls):
    got = pe.get_2d_sincos_pos_embed(dim, gh, gw, cls_token=cls)
    want = jpe.get_2d_sincos_pos_embed(dim, gh, gw, cls_token=cls)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_in,n_out", [(196, 512), (512, 196), (16, 16)])
def test_token_resample_is_jax_bit_for_bit(n_in, n_out):
    pos = np.random.RandomState(n_in).randn(1, n_in, 8).astype(np.float32)
    got = pe.interp_pos_embed_tokens(torch.from_numpy(pos), n_out)
    want = jpe.interp_pos_embed_tokens(jnp.asarray(pos), n_out)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _grid(old, dim=64, seed=0):
    return np.random.RandomState(seed).randn(1, 1 + old * old,
                                             dim).astype(np.float32)


@pytest.mark.parametrize("new", [(16, 16), (24, 24), (8, 8), (8, 64)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_bicubic_resize_matches_jax_image_resize(new):
    """Grid 14 x 14 (+ one prefix row) to ``new``: within 1e-5 of
    ``jax.image.resize(..., 'bicubic')``, the prefix row unchanged."""
    pos = _grid(14)
    got = pe.interpolate_pos_embed_2d(torch.from_numpy(pos), new)
    want = np.asarray(jax.device_get(jpe.interpolate_pos_embed_2d(
        jnp.asarray(pos), new)))
    assert got.shape == want.shape == (1, 1 + new[0] * new[1], 64)
    np.testing.assert_array_equal(got[:, :1].numpy(), pos[:, :1])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_bicubic_without_antialias_is_off():
    """The plain bicubic call, without ``antialias``, samples the same
    positions but lies more than 0.1 off JAX's where the grid grows (14 ->
    24) as where it shrinks (14 -> 8): the reason the port passes it."""
    pos = _grid(14)
    grid = torch.from_numpy(pos[:, 1:]).reshape(1, 14, 14, 64).permute(
        0, 3, 1, 2)
    for new in ((24, 24), (8, 8)):
        plain = F.interpolate(grid, size=new, mode="bicubic",
                              align_corners=False)
        plain = plain.permute(0, 2, 3, 1).reshape(1, -1, 64).numpy()
        want = np.asarray(jax.device_get(jpe.interpolate_pos_embed_2d(
            jnp.asarray(pos), new)))[:, 1:]
        assert np.abs(plain - want).max() > 0.1
