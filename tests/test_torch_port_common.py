"""Shared pieces of the port's parity tests (tests/test_torch_port_*.py);
this module itself holds no tests.

Both packages run on the CPU in float32 at a tiny geometry whose widths meet
the Pallas kernels' 128-alignment: ViT dim 128 with 2 heads (D=64), decoder
dim 128 with 4 heads (D=32). Audio is 32 mel bins x 128 frames (a 2 x 8
patch grid, 16 tokens), video one 48 x 48 frame (9 tokens), so the decoder
runs at 25 tokens: not a multiple of 16.

Random draws: ``record_draws`` runs the JAX model with its masking
functions and random draws wrapped (``recording_draws``: pytest
monkeypatch, nothing in the JAX package changes) and returns the noise and
permutations JAX drew from the given keys as the port's ``MaskDraws``, in
the layout of the model's contrastive form.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import avsiam_tpu.models.cavmae as jcavmae
import avsiam_tpu.ops.masking as jmasking
from avsiam_tpu import configs as jc
from avsiam_tpu_torch import configs as pc
from avsiam_tpu_torch.models.cavmae import MaskDraws

VIT = dict(dim=128, depth=1, num_heads=2, patch_size=16, img_size=48,
           audio_length=128, mel_bins=32)
DEC = dict(dim=128, depth=1, num_heads=4)


def configs(batch: int = 9, lr: float = 1e-3, vit=None, **model_kw):
    """(JAX PretrainConfig, port PretrainConfig) of the tiny geometry in the
    bench configuration's impls, float32; ``vit`` overrides ViT fields."""
    vit = dict(VIT, **(vit or {}))
    jm = jc.CAVMAEConfig(vit=jc.ViTConfig(**vit),
                         decoder=jc.DecoderConfig(**DEC), mmixed_impl="exact",
                         attn_impl="pallas", mlp_impl="lnfres", **model_kw)
    pm = pc.CAVMAEConfig(vit=pc.ViTConfig(**vit),
                         decoder=pc.DecoderConfig(**DEC), mmixed_impl="exact",
                         attn_impl="auto", mlp_impl="lnfres", **model_kw)
    return (jc.PretrainConfig(model=jm, opt=jc.OptimizerConfig(lr=lr),
                              batch_size=batch),
            pc.PretrainConfig(model=pm, opt=pc.OptimizerConfig(lr=lr),
                              batch_size=batch))


def batch(n: int, seed: int = 0):
    """(audio [n, 128, 32], frames [n, 3, 48, 48]) float32 numpy."""
    rs = np.random.RandomState(seed)
    a = rs.randn(n, VIT["audio_length"], VIT["mel_bins"]).astype(np.float32)
    v = rs.randn(n, 3, VIT["img_size"], VIT["img_size"]).astype(np.float32)
    return a, v


@contextlib.contextmanager
def recording_draws(monkeypatch):
    """Within the block, the JAX masking functions, ``take_batch``,
    ``jax.random.permutation`` and ``jax.random.uniform`` are wrapped to
    collect what they draw (pytest monkeypatch: nothing in the JAX package
    changes). Yields the dict of lists they fill, which a jitted function
    can return beside the model's outputs; ``draws_from`` turns it into the
    port's ``MaskDraws``."""
    rec = dict(uniform=[], structured=[], batch_ids=[], perms=[],
               uniforms=[])
    orig_rm = jmasking.random_masking
    orig_sn = jmasking.structured_noise
    orig_tb = jcavmae.take_batch
    orig_perm = jax.random.permutation
    orig_uniform = jax.random.uniform

    def rm(rng, x, len_keep, noise=None, pad_to=None):
        if noise is None:  # the same draw random_masking makes itself
            noise = jax.random.uniform(rng, x.shape[:2])
            rec["uniform"].append(noise)
        return orig_rm(rng, x, len_keep, noise=noise, pad_to=pad_to)

    def sn(rng, N, f, t, mask_ratio, mode="tf"):
        k_base, k_t, k_f = jax.random.split(rng, 3)  # as structured_noise
        rec["structured"].append((jax.random.uniform(k_base, (N, f, t)),
                                  jax.random.uniform(k_t, (N, t)),
                                  jax.random.uniform(k_f, (N, f))))
        return orig_sn(rng, N, f, t, mask_ratio, mode)

    def tb(x, ids, impl="auto"):
        rec["batch_ids"].append(ids)
        return orig_tb(x, ids, impl)

    def perm(*args, **kw):
        out = orig_perm(*args, **kw)
        rec["perms"].append(out)
        return out

    def uniform(*args, **kw):  # every uniform draw, in order
        out = orig_uniform(*args, **kw)
        rec["uniforms"].append(out)
        return out

    with monkeypatch.context() as m:
        m.setattr(jmasking, "random_masking", rm)
        m.setattr(jmasking, "structured_noise", sn)
        m.setattr(jcavmae, "take_batch", tb)
        m.setattr(jax.random, "permutation", perm)
        m.setattr(jax.random, "uniform", uniform)
        yield rec


def draws_from(rec, mae_w, con_w, mmixed_impl: str) -> MaskDraws:
    """The port's ``MaskDraws`` from what ``recording_draws`` collected (as
    numpy) over one forward with these loss weights and form."""
    t = torch.from_numpy
    uniform = rec["uniform"]
    d = MaskDraws()
    if mae_w != 0:  # forward_encoder draws audio, then video
        d.noise_a, d.noise_v = t(uniform[0]), t(uniform[1])
        uniform = uniform[2:]
    if con_w != 0 and mmixed_impl == "padded":
        # the two permutations, then the last four uniforms: base, r_t, r_f
        # and the video noise from one 'mask' key split four ways
        d.perm_a, d.perm_v = (t(p).long() for p in rec["perms"])
        d.padded_a = tuple(t(u) for u in rec["uniforms"][-4:-1])
        d.padded_v = t(rec["uniforms"][-1])
    elif con_w != 0:
        n = len(rec["structured"])  # chunks: (idx_a, idx_v) each, then 2
        ids = rec["batch_ids"]  # restores
        d.perm_a = t(np.concatenate(ids[0:2 * n:2])).long()
        d.perm_v = t(np.concatenate(ids[1:2 * n:2])).long()
        d.chunk_a = [tuple(t(u) for u in s) for s in rec["structured"]]
        d.chunk_v = [t(u) for u in uniform]
    return d


def record_draws(monkeypatch, model, params, a, v, mae_w, con_w, rngs):
    """Run ``model.apply`` (jitted) and capture the draws it makes: returns
    (the JAX model's outputs, the port's ``MaskDraws``). The wrapped masking
    functions collect their draws while the forward is traced, and the jitted
    function returns them beside the model's outputs."""

    def run(params, a, v, rngs):
        with recording_draws(monkeypatch) as rec:
            out = model.apply({"params": params}, a, v,
                              mae_loss_weight=mae_w,
                              contrast_loss_weight=con_w, rngs=rngs)
        return out, rec

    out, rec = jax.jit(run)(params, jnp.asarray(a), jnp.asarray(v), rngs)
    rec = jax.tree_util.tree_map(np.array, rec)
    return out, draws_from(rec, mae_w, con_w, model.cfg.mmixed_impl)


def to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def array_leaves(tree):
    """A nested dict keeping only array leaves (drops optax MaskedNodes)."""
    out = {}
    for k, val in tree.items():
        if isinstance(val, dict):
            sub = array_leaves(val)
            if sub:
                out[k] = sub
        elif hasattr(val, "shape") and hasattr(val, "dtype"):
            out[k] = np.asarray(val)
    return out


def jax_param_paths(depth: int = 2):
    """'/'-joined paths of the JAX model's full parameter tree (shapes only,
    via ``jax.eval_shape``: nothing is compiled)."""
    from flax import traverse_util

    from avsiam_tpu.models import CAVMAEPretrain as JaxModel
    jcfg, _ = configs()
    m = jcfg.model
    m = jc.replace(m, vit=jc.replace(m.vit, depth=depth),
                   decoder=jc.replace(m.decoder, depth=depth))
    a, v = batch(2)
    key = jax.random.PRNGKey(0)
    tree = jax.eval_shape(JaxModel(m).init,
                          {"params": key, "mask": key, "perm": key}, a, v)
    return list(traverse_util.flatten_dict(tree["params"], sep="/"))
