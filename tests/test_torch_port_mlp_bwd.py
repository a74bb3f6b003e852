"""Port parity of the MLP backward's two passes (K7, K8 on the card): the
plain version of the gh pass (gh, act and the per-row-tile float32 column
sums of gh that K7 folds into db1) and of the dx pass, against the JAX
package's Pallas kernels in interpret mode, and the pure tiling helpers the
kernels' wrappers pick their grids with.

The JAX functions are ``_bwd_call_split`` (its ``_bwd_dx_kernel`` gives dx,
gh and act; gh and act are read off its ``pallas_call`` with pytest's
monkeypatch, nothing in the JAX package changes) and ``_bwd_call`` (the
single kernel, whose db1 sums the float32 gh). Widths D 128 and 256 (the
Pallas kernels take any multiple of 128), H = 4 D, on a row count that is
a multiple of none of the tiles (Pallas 128 and 256, the gh pass's 128).

The JAX side of every case is computed once, by this file run as a script
in a fresh interpreter (``jax_side``), and handed over with the inputs it
was given: what an earlier test file left in the worker's process (its JAX
configuration, its compiled kernels, a patched ``pallas_call``) cannot
reach it. Each comparison's failure names the dx kernel's call count, the
largest error of each output and ``torch.get_num_threads()``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from avsiam_tpu_torch.ops import mlp as pmlp

ROWS = 300
WIDTHS = (128, 256)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT_TIMEOUT = 300  # seconds


def _inputs(d, seed, dtype):
    """JAX-layout arrays of ``dtype`` (b1 stays float32 values rounded to
    it): x [ROWS, d], w1 [d, 4d], b1 [1, 4d], w2 [4d, d], do [ROWS, d]."""
    import jax.numpy as jnp
    h = 4 * d
    rs = np.random.RandomState(seed)
    f = lambda *s, k=1.0: jnp.asarray(  # noqa: E731
        (rs.randn(*s) * k).astype(np.float32)).astype(dtype)
    return dict(x=f(ROWS, d), w1=f(d, h, k=d ** -0.5), b1=f(1, h, k=0.1),
                w2=f(h, d, k=h ** -0.5), do=f(ROWS, d))


def _split_kernel_outputs(monkeypatch, p):
    """(dx, gh, act) of ``_bwd_call_split``'s dx kernel, the function's own
    (dx, dw1, db1, dw2, db2), and how many times the dx kernel ran."""
    import jax.numpy as jnp

    from avsiam_tpu.ops import mlp as jmlp
    seen = []
    real = jmlp.pl.pallas_call

    def spy(kernel, *args, **kw):
        call = real(kernel, *args, **kw)
        name = getattr(getattr(kernel, "func", kernel), "__name__", "")

        def run(*operands):
            out = call(*operands)
            if name == "_bwd_dx_kernel":
                seen.append([np.asarray(o[:ROWS].astype(jnp.float32))
                             for o in out])
            return out
        return run

    monkeypatch.setattr(jmlp.pl, "pallas_call", spy)
    grads = jmlp._bwd_call_split(p["x"], p["w1"], p["b1"], p["w2"], p["do"],
                                 "erf")
    first = seen[0] if seen else [np.full((1,), np.nan)] * 3
    return first, [np.asarray(g.astype(jnp.float32)) for g in grads], len(seen)


def _script(out_path):
    """The JAX side of every case, in this fresh interpreter, to
    ``out_path`` (npz): each case's inputs as float32 values, and the
    kernels' outputs. The suite's JAX settings (``tests/conftest.py``),
    without its persistent compile cache: every kernel compiles here."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp

    from avsiam_tpu.ops import mlp as jmlp
    os.environ.pop("AVSIAM_MLP_BWD", None)
    out = {}

    def keep(tag, p):
        for k, v in p.items():
            out[f"{tag}/in/{k}"] = np.asarray(v.astype(jnp.float32))

    with pytest.MonkeyPatch.context() as mp:
        for d in WIDTHS:
            p = _inputs(d, d, jnp.float32)
            keep(f"gh{d}", p)
            (dx, gh, act), _, n = _split_kernel_outputs(mp, p)
            out.update({f"gh{d}/dx": dx, f"gh{d}/gh": gh, f"gh{d}/act": act,
                        f"gh{d}/count": np.int64(n)})
        for d in WIDTHS:
            p = _inputs(d, d + 1, jnp.float32)
            keep(f"single{d}", p)
            for k, g in zip(("dx", "dw1", "db1", "dw2", "db2"), jmlp._bwd_call(
                    p["x"], p["w1"], p["b1"], p["w2"], p["do"], "erf")):
                out[f"single{d}/{k}"] = np.asarray(g)
        for d in WIDTHS:
            p = _inputs(d, d + 2, jnp.bfloat16)
            keep(f"bf16_{d}", p)
            out[f"bf16_{d}/db1_7"] = np.asarray(jmlp._bwd_call(
                p["x"], p["w1"], p["b1"], p["w2"], p["do"], "erf")[2])
            (_, gh, _), grads, n = _split_kernel_outputs(mp, p)
            out.update({f"bf16_{d}/gh": gh, f"bf16_{d}/db1_8": grads[2],
                        f"bf16_{d}/count": np.int64(n)})
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The script's results, read back."""
    out = str(tmp_path_factory.mktemp("mlp_bwd") / "jax_side.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        filter(None, [REPO, os.path.join(REPO, "tests"),
                      os.environ.get("PYTHONPATH")])))
    env.pop("AVSIAM_MLP_BWD", None)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), out],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=SCRIPT_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-6000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _port(ref, tag, dtype=torch.float32):
    """The port's operands of a case: its inputs as ``dtype`` tensors,
    weights in nn.Linear's layout, b1 flat."""
    t = {k: torch.from_numpy(ref[f"{tag}/in/{k}"])
         for k in ("x", "w1", "b1", "w2", "do")}
    x, w1, b1, w2, do = (t["x"], t["w1"].T.contiguous(), t["b1"][0],
                         t["w2"].T.contiguous(), t["do"])
    return tuple(u.to(dtype) for u in (x, w1, b1, w2, do))


def _check_close(checks, context):
    """Each (name, got, want, rtol, atol) within its tolerance; a failure
    lists every output's largest error and ``context``."""
    errs, bad = [], []
    for name, got, want, rtol, atol in checks:
        diff = np.abs(np.asarray(got, np.float64) - want)
        errs.append(f"{name} {diff.max():.3g} (atol {atol:g}, rtol {rtol:g})")
        if not (diff <= atol + rtol * np.abs(want)).all():
            bad.append(name)
    assert not bad, (f"{', '.join(bad)} off; largest errors: "
                     f"{'; '.join(errs)}; {context}; torch threads "
                     f"{torch.get_num_threads()}")


@pytest.mark.parametrize("d", WIDTHS)
def test_gh_pass_matches_the_split_kernel(jax_side, d):
    """float32: the gh pass's act within 1e-5 (a forward value) and gh
    within 1e-4 (a gradient) of ``_bwd_dx_kernel``'s, the dx pass's dx
    within 1e-4 of its dx."""
    ref, tag = jax_side, f"gh{d}"
    count = int(ref[f"{tag}/count"])
    assert count == 1, f"the dx kernel ran {count} times"
    x, w1, b1, w2, do = _port(ref, tag)
    gh, act, parts = pmlp.mlp_gh_reference(x, w1, b1, w2, do)
    assert parts.shape == (-(-ROWS // pmlp.GH_TILE), 4 * d)
    _check_close([("act", act.numpy(), ref[f"{tag}/act"], 1e-5, 1e-5),
                  ("gh", gh.numpy(), ref[f"{tag}/gh"], 1e-4, 1e-4),
                  ("dx", pmlp.mlp_dx_reference(gh, w1).numpy(),
                   ref[f"{tag}/dx"], 1e-4, 1e-4)],
                 f"the dx kernel ran {count} time(s)")


@pytest.mark.parametrize("d", WIDTHS)
def test_folded_db1_matches_the_single_kernel(jax_side, d):
    """float32: the fold of the gh pass's row-tile sums is ``_bwd_call``'s
    db1 within 1e-4, and the plain K7 gives all five gradients within 1e-4
    of it."""
    ref, tag = jax_side, f"single{d}"
    want = {k: ref[f"{tag}/{k}"] for k in ("dx", "dw1", "db1", "dw2", "db2")}
    x, w1, b1, w2, do = _port(ref, tag)
    _, _, parts = pmlp.mlp_gh_reference(x, w1, b1, w2, do)
    got = pmlp.mlp_bwd_reference(x, w1, b1, w2, do)
    _check_close([("folded db1", pmlp.fold_rows(parts).numpy(), want["db1"],
                   1e-4, 1e-4)] + [
        # the weight gradients in nn.Linear's layout
        (name, g.numpy(), want[name].T if name in ("dw1", "dw2")
         else want[name], 1e-4, 1e-4)
        for name, g in zip(("dx", "dw1", "db1", "dw2", "db2"), got)],
        "the single kernel")


def _bf16(a):
    """float32 values rounded to bfloat16 (to nearest even, as JAX's cast)
    and back."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float(
        ).numpy()


@pytest.mark.parametrize("d", WIDTHS)
def test_bf16_db1_forms_match_jax(jax_side, d):
    """bfloat16: K7's db1 (the fold of the float32 gh's row-tile sums) and
    the split backward's (K9's sum of the bf16 gh the gh pass stores),
    rounded to bfloat16 as both packages hand them to b1, equal the JAX
    package's ``_bwd_call`` and ``_bwd_call_split`` db1; the two forms
    differ. Both sums run in another float32 order than JAX's, so
    an element whose sum lies at a bf16 rounding tie may round the other
    way: at most 1% of the elements may differ, each by one bf16 step (0-2
    of 512 or 1024 do over seeds 0-4). The stored gh likewise."""
    ref, tag = jax_side, f"bf16_{d}"
    count = int(ref[f"{tag}/count"])
    assert count == 1, f"the dx kernel ran {count} times"
    x, w1, b1, w2, do = _port(ref, tag, torch.bfloat16)
    gh, _, parts = pmlp.mlp_gh_reference(x, w1, b1.float(), w2, do)
    assert gh.dtype == torch.bfloat16
    # gh itself matches but for float32 sum-order ties at the bf16 rounding
    assert (gh.float().numpy() != ref[f"{tag}/gh"]).mean() <= 0.01
    db1_7 = _bf16(pmlp.fold_rows(parts).numpy())
    db1_9 = _bf16(pmlp.weight_grads_reference(x, gh)[1].numpy())
    for got, want in ((db1_7, _bf16(ref[f"{tag}/db1_7"])),
                      (db1_9, _bf16(ref[f"{tag}/db1_8"]))):
        off = got != want
        assert off.mean() <= 0.01
        # one bf16 step: 2^-8 of the value's binade
        assert (np.abs(got - want)[off] <= np.abs(want[off]) / 2 ** 7).all()
    assert (db1_7 != db1_9).mean() > 0.1


@pytest.mark.parametrize("rows", [1, 127, 128, 300, 1416])
def test_row_tile_sums_fold_to_the_column_sums(rows):
    """``row_tile_sums`` holds each 128-row tile's column sums (rows past
    the end count as zeros) and ``fold_rows`` adds them in tile order to
    the column sums within float32 rounding."""
    g = torch.randn((rows, 192), generator=torch.Generator().manual_seed(rows))
    parts = pmlp.row_tile_sums(g)
    assert parts.shape == (-(-rows // 128), 192)
    for i in range(parts.shape[0]):
        assert torch.equal(parts[i], g[128 * i:128 * (i + 1)].sum(dim=0))
    torch.testing.assert_close(pmlp.fold_rows(parts), g.sum(dim=0),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dim", [128, 256, 384, 512, 640, 768, 896, 1024,
                                 1152, 1280, 1536, 2048])
def test_every_128_aligned_width_is_taken(dim):
    """The width rule: every D that is a multiple of 128 (H = 4 D) passes
    the kernels' geometry check, which then wants a CUDA tensor; K3/K4's
    passes take it whole at any row count (fc2 tiles of 128 of D's columns,
    D entering fc1 only as the reduction length), the fc2 pass splitting H
    into 1 to 16 ranges."""
    assert pmlp.kernel_takes(dim, 4 * dim)
    x = torch.empty((5, dim), device="meta")
    w1 = torch.empty((4 * dim, dim), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pmlp._rows_geometry("MLP", x, w1)
    assert dim % pmlp.DX_TILE == 0
    for rows in (1, 37, 156, 1416, 5664):
        splits = pmlp.dx_splits(rows, dim, 4 * dim, 132)
        assert 1 <= splits <= min(4 * dim // 64, pmlp.MAX_SPLITS)


@pytest.mark.parametrize("dim,hidden", [(64, 256), (200, 800), (768, 96),
                                        (0, 512)])
def test_widths_the_kernels_refuse(dim, hidden):
    """D not a multiple of 128, or H not of 64, is refused before the
    device is looked at; 'auto' does not take the kernels there."""
    assert not pmlp.kernel_takes(dim, hidden)
    x = torch.empty((5, dim), device="meta")
    w1 = torch.empty((hidden, dim), device="meta")
    with pytest.raises(ValueError, match="multiple of"):
        pmlp._rows_geometry("MLP", x, w1)


@pytest.mark.parametrize("rows,dim,hidden", [
    (156, 768, 3072), (1024, 768, 3072), (1416, 768, 3072),
    (5664, 512, 2048), (156, 1280, 5120), (1416, 1280, 5120), (37, 1024, 4096),
    (1, 128, 64)])
def test_dx_splits_take_the_least_modelled_time(rows, dim, hidden):
    """The dx pass's split of H: every range holds a 64-wide slab, the split
    costs no more than none at all, and no other split count costs less
    (waves x slabs per block plus the partial sums' traffic, 132 SMs)."""
    s = pmlp.dx_splits(rows, dim, hidden, 132)
    slabs = hidden // 64
    assert 1 <= s <= min(slabs, pmlp.MAX_SPLITS)
    tiles = -(-rows // 128) * (dim // 128)

    def cost(k):
        extra = k * rows * dim * 8 / pmlp.PARTIAL_BYTES_PER_STEP if k > 1 else 0
        return -(-tiles * k // 132) * -(-slabs // k) + extra

    assert cost(s) <= cost(1)
    assert cost(s) == min(cost(k) for k in range(1, min(slabs, 16) + 1))


if __name__ == "__main__":
    _script(sys.argv[1])
