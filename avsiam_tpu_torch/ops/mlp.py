"""The transformer MLP ``fc2(gelu(fc1(x)))``, alone or as the block's whole
MLP sub-block ``x + fc2(gelu(fc1(LN(x))))``, and their backwards.

Counterpart of ``avsiam_tpu/ops/mlp.py``: ``fused_ln_mlp`` (the 'lnfres'
path) and ``fused_mlp`` with its three custom VJPs. The Pallas kernels are
the CUDA kernels of ``csrc/ln_mlp.cu`` and ``csrc/mlp.cu``:

- K3 ``ln_mlp_fwd_kernel`` (``_lnfwd_call``): LN -> fc1 -> GELU -> fc2 ->
  residual, emitting the pre-GELU hidden: the LN rows kernel
  (``ln_mlp_rows_kernel``, LN(x) in bf16), then K4's two passes, the fc2
  pass adding the residual;
- K4 ``mlp_fwd_kernel`` (``_fwd_call``): fc1 -> GELU -> fc2, optionally
  emitting the pre-GELU hidden: the fc1 pass (``mlp_fc1_kernel``: hpre, and
  act in bf16) and the fc2 pass (``mlp_fc2_kernel``: act w2^T + b2);
- K7 ``mlp_bwd_kernel`` (``_bwd_call``): the backward recomputing the hidden,
  dx plus float32 dw1, db1, dw2, db2: the gh pass (``mlp_gh_kernel``, with
  the per-row-tile float32 column sums of gh folded into db1), the dx pass
  (``mlp_dx_kernel``) and K9 twice;
- K8 ``mlp_bwd_dx_kernel`` (``_bwd_call_split``): dx, stashing gh and act:
  the gh pass and the dx pass;
- K9 ``weight_grads_kernel`` (``weight_grads``): a weight gradient g^T a and
  its bias gradient, the column sums of g.

The impls of ``fused_mlp``: 'fused' is K4 forward and K7 backward; 'fbwd' the
plain dense forward (bit for bit the 'dense' ``Mlp``, true 'erf') and K7
backward; 'fres' K4 forward saving the pre-GELU hidden, and a backward from
it (``_saved_hidden_bwd``), as the 'lnfres' backward is: cuBLAS products
around the GELU-backward pass (``mlp_gelu_bwd_kernel``: gh, act and db1
from dh = do w2 and the saved hidden, in one pass). That pass replaces no
TPU kernel: the JAX package's backward is plain XLA, whose fusions take
the elementwise tail. The 'lnfres' backward recomputes LN(x) with K3's
rows kernel and runs K10 (``ops/layernorm.py``) for the LayerNorm's VJP.
On a CPU tensor both backwards run the plain composite.
``AVSIAM_MLP_BWD=split``, read at each backward, routes K7 to K8 plus K9
twice.

Numerics: GEMM operands in the activation dtype with float32 accumulation,
float32 GELU in the asked form ('erf' evaluated as 'ans', as the Pallas
kernels do; ``gelu.kernel_impl``), the
pre-GELU hidden saved in the activation dtype. K7's db1 sums the float32
gh; 'fres' and K9 sum gh after its cast to the activation dtype.

Weights use nn.Linear's layout: w1 [H, D] (fc1.weight), w2 [D, H]
(fc2.weight), and so do their gradients. The kernels take every D that is a
multiple of 128 and every H that is a multiple of 64 (K7 of 128, K9's
tiles), as the Pallas kernels take multiples of 128
(``avsiam_tpu/ops/mlp.py:533,580``). On a CPU tensor each kernel's wrapper
takes its plain version; on a CUDA tensor it launches the kernel or raises.

Tensor parallelism (``group``, the model group; ``parallel/tp.py``): w1
and b1 are this rank's rows of the hidden width and w2 its columns. The
fc2 pass then gives a partial product, which the kernels write in float32
with no bias and no residual (``partial``); it is summed over the group in
float32, and b2 and the residual are added once, after the sum, as the
unsharded kernels add them to their float32 accumulator (b2) and to its
cast (the residual). The backward's partial dx of the MLP's input is
likewise written in float32 (``dx_dtype``) and summed before its cast, the
residual's gradient and the LayerNorm backward. Without a group every
route is as it is unsharded.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
import torch.nn.functional as F

from avsiam_tpu_torch import kernels
from avsiam_tpu_torch.ops.gelu import gelu as gelu_op
from avsiam_tpu_torch.ops.gelu import (KERNEL_CODES, gelu_act_grad_f32,
                                       gelu_f32, kernel_impl)
from avsiam_tpu_torch.ops.layernorm import (layer_norm, layer_norm_vjp,
                                            ln_bwd_kernel)

FUSED_IMPLS = ("fused", "fbwd", "fres")
DIM_ALIGN = 128    # the kernels take D a multiple of it
HIDDEN_CHUNK = 64  # hidden columns per step of the kernels' loops
MAX_SPLITS = 16    # bounds the f32 partial sums at 16 x [T, D]
WEIGHT_GRAD_TILE = 128  # K9 takes dw [n, m] with m and n multiples of it
WEIGHT_GRAD_TILES = ((192, 96), (128, 128))  # K9's bf16 dw tiles (rows, cols)
GH_TILE = 128      # the gh pass: rows and hidden columns per block
DX_TILE = 128      # the dx and fc2 passes: rows and columns of a block's tile
# the dx pass's split cost: bytes of f32 partial sums written and read back
# that take about as long as one block's 128 x 128 x 64 product step
PARTIAL_BYTES_PER_STEP = 1 << 20


def kernel_takes(dim: int, hidden: int) -> bool:
    """Whether the MLP kernels take an MLP of width ``dim`` and hidden width
    ``hidden``: the Pallas kernels' rule, D and H multiples of 128
    (``avsiam_tpu/ops/mlp.py:533,580``; the forward kernels and K8 also take
    H a multiple of 64)."""
    return (dim > 0 and dim % DIM_ALIGN == 0 and hidden > 0
            and hidden % DIM_ALIGN == 0)


def dx_splits(rows: int, dim: int, hidden: int, num_sms: int) -> int:
    """Into how many ranges the dx pass of K7/K8 splits its reduction over
    H. A block owns a 128 x 128 tile of dx and takes time in proportion to
    its 64-wide slabs of H; a split adds its f32 partial sums ([rows, D]
    written and read back once more each). The split count with the least
    waves * slabs per block plus that traffic, the smallest on a tie."""
    tiles = -(-rows // DX_TILE) * (dim // DX_TILE)
    slabs = hidden // HIDDEN_CHUNK

    def cost(s):
        extra = s * rows * dim * 8 / PARTIAL_BYTES_PER_STEP if s > 1 else 0
        return -(-tiles * s // num_sms) * -(-slabs // s) + extra

    return min(range(1, min(slabs, MAX_SPLITS) + 1), key=cost)


def weight_grad_tile(m: int, n: int, num_sms: int):
    """K9's bf16 dw tile (rows, columns) for dw [n, m]: of the tiles that
    divide it, the one whose call takes the least waves * tile area (a
    block fills an SM and takes time in proportion to its area). At ViT-B's
    (768, 3072) 192 x 96 gives 128 tiles, one wave on 132 SMs, where 128 x
    128 gives 144, two waves."""
    def cost(tile):
        r, c = tile
        return -(-(n // r) * (m // c) // num_sms) * r * c

    return min((t for t in WEIGHT_GRAD_TILES if n % t[0] == 0 and m % t[1] == 0),
               key=cost)


def ln_mlp_reference(x2, ln_scale, ln_bias, w1, b1, w2, b2, eps: float,
                     gelu: str = "erf", partial: bool = False):
    """Plain version on [T, D] rows: returns (out, pre-GELU hidden), both in
    x2's dtype; products in float32 from the given values. With
    ``partial`` out is the float32 act w2^T alone (no b2, no residual)."""
    dt = x2.dtype
    f32 = torch.float32
    n = layer_norm(x2, ln_scale, ln_bias, eps)
    hpre = n.to(f32) @ w1.to(f32).T + b1.to(f32)
    act = gelu_f32(hpre, kernel_impl(gelu)).to(dt)
    if partial:
        return act.to(f32) @ w2.to(f32).T, hpre.to(dt)
    y = act.to(f32) @ w2.to(f32).T + b2.to(f32)
    return x2 + y.to(dt), hpre.to(dt)


def _rows_geometry(name: str, x2: torch.Tensor, w1: torch.Tensor):
    """(T, D, H) of a kernel call on [T, D] rows, or ValueError: the width
    rule first, then the device."""
    if x2.dtype not in kernels.DTYPE_CODES or x2.dim() != 2:
        raise ValueError(f"{name}: rows must be [T, D] float32 or bfloat16, "
                         f"got {tuple(x2.shape)} {x2.dtype}")
    T, D = x2.shape
    H = w1.shape[0]
    if D % DIM_ALIGN or H % HIDDEN_CHUNK or T == 0 or D == 0 or H == 0:
        raise ValueError(f"{name} kernel takes D a multiple of {DIM_ALIGN}, "
                         f"H a multiple of {HIDDEN_CHUNK} and T > 0; got "
                         f"T={T}, D={D}, H={H}")
    if x2.device.type != "cuda":
        raise ValueError(f"{name} kernel needs a CUDA tensor, got {x2.device}")
    if not x2.is_contiguous():
        raise ValueError(f"{name}: rows must be contiguous")
    return T, D, H


def _check_aligned(name: str, *tensors) -> None:
    """The MLP kernels of ``csrc/mlp.cu`` read rows with 16-byte loads."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: row tensors must start 16-byte aligned")


def _check_operands(name: str, device, *specs) -> None:
    """Each (label, tensor, shape, dtype) must match and be a contiguous
    32-byte-aligned tensor on ``device`` (TMA reads weights in place)."""
    for label, t, shape, dtype in specs:
        if (t.shape != shape or t.dtype != dtype or t.device != device
                or not t.is_contiguous() or t.data_ptr() % 32 != 0):
            raise ValueError(f"{name}: {label} must be a contiguous "
                             f"32-byte-aligned {shape} {dtype} tensor on "
                             f"{device}")


def _weight_specs(w1, b1, w2, D, H, b2=None):
    bf16, f32 = torch.bfloat16, torch.float32
    specs = [("w1", w1, (H, D), bf16), ("b1", b1, (H,), f32),
             ("w2", w2, (D, H), bf16)]
    if b2 is not None:
        specs.append(("b2", b2, (D,), f32))
    return specs


def _kernel_weights(w1, b1, w2, b2=None):
    """Weights in bf16 and biases in f32, as the kernels take them."""
    bf16, f32 = torch.bfloat16, torch.float32
    return (w1.to(bf16).contiguous(), b1.to(f32).contiguous(),
            w2.to(bf16).contiguous(),
            None if b2 is None else b2.to(f32).contiguous())


# ------------------------------------------------------ K3, K4 forward
def mlp_fc1_reference(x2, w1, b1, gelu: str = "erf"):
    """Plain version of the fc1 pass on [T, D] rows: (the pre-GELU hidden
    in float32, act = gelu(hidden) rounded to x2's dtype, as the JAX kernels
    round it before fc2); products in float32 from the given values."""
    f32 = torch.float32
    hpre = x2.to(f32) @ w1.to(f32).T + b1.to(f32)
    return hpre, gelu_f32(hpre, kernel_impl(gelu)).to(x2.dtype)


def mlp_fc2_reference(act, w2, b2, resid=None):
    """Plain version of the fc2 pass: act @ w2^T + b2 in float32, rounded
    to act's dtype, then ``resid +`` that in that dtype (K3) where given;
    with b2 None the float32 act @ w2^T alone (the partial form)."""
    f32 = torch.float32
    if b2 is None:
        return act.to(f32) @ w2.to(f32).T
    y = (act.to(f32) @ w2.to(f32).T + b2.to(f32)).to(act.dtype)
    return y if resid is None else resid + y


def _fc1_pass(x16, w1, b1, dtype, save_hpre: bool, gelu: str = "erf"):
    """The fc1 pass on the card: (hpre [T, H] in ``dtype`` or None, act
    [T, H] in bf16, GELU in ``kernel_impl(gelu)``'s form) from bf16 rows
    x16."""
    T, D = x16.shape
    H = w1.shape[0]
    dev = x16.device
    hpre = (torch.empty((T, H), dtype=dtype, device=dev) if save_hpre
            else None)
    act = torch.empty((T, H), dtype=torch.bfloat16, device=dev)
    err = kernels.library().avsiam_mlp_fc1(
        x16.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        None if hpre is None else hpre.data_ptr(), act.data_ptr(), T, D, H,
        kernels.DTYPE_CODES[dtype], KERNEL_CODES[kernel_impl(gelu)],
        kernels.stream_handle(x16))
    kernels.check(err, "MLP forward fc1 pass")
    return hpre, act


def _fc2_pass(act, w2, b2, dtype, splits: int, resid=None):
    """The fc2 pass on the card: act [T, H] (bf16) @ w2^T + b2 in
    ``dtype``, plus ``resid`` [T, D] where given (K3), H split into
    ``splits`` ranges. b2 None: the partial form, act @ w2^T in float32
    (``dtype`` must be float32; the kernel adds a zero bias, which leaves
    every float32 sum as it is)."""
    T, H = act.shape
    D = w2.shape[0]
    dev = act.device
    if b2 is None:
        if dtype != torch.float32 or resid is not None:
            raise ValueError("the fc2 pass's partial form is float32, with "
                             "no residual")
        b2 = torch.zeros((D,), dtype=torch.float32, device=dev)
    out = torch.empty((T, D), dtype=dtype, device=dev)
    partial = (torch.empty((splits, T, D), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    err = kernels.library().avsiam_mlp_fc2(
        act.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        None if resid is None else resid.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), T, D, H, splits,
        kernels.DTYPE_CODES[dtype], kernels.stream_handle(act))
    kernels.check(err, "MLP forward fc2 pass")
    return out


def _fwd_passes(x16, w1, b1, w2, b2, dtype, save_hpre: bool, resid=None,
                gelu: str = "erf"):
    """The fc1 and fc2 passes, the fc2 pass splitting H as the dx pass
    does (``dx_splits``: the same [T, H] by [H, D] product): (out, hpre or
    None) in ``dtype``; b2 None: out is the float32 partial product."""
    T, D = x16.shape
    H = w1.shape[0]
    hpre, act = _fc1_pass(x16, w1, b1, dtype, save_hpre, gelu)
    splits = dx_splits(T, D, H, kernels.num_sms(x16.device))
    out_dtype = torch.float32 if b2 is None else dtype
    return _fc2_pass(act, w2, b2, out_dtype, splits, resid), hpre


def _ln_rows(x2, ln_scale, ln_bias, eps: float):
    """K3's LayerNorm rows kernel on the card: LN(x2) [T, D] in bf16, the
    rows the fc1 pass reads (LN parameters f32)."""
    T, D = x2.shape
    n16 = torch.empty((T, D), dtype=torch.bfloat16, device=x2.device)
    err = kernels.library().avsiam_ln_mlp_rows(
        x2.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), n16.data_ptr(),
        T, D, kernels.DTYPE_CODES[x2.dtype], eps, kernels.stream_handle(x2))
    kernels.check(err, "LN-MLP LayerNorm rows")
    return n16


def ln_mlp_fwd_kernel(x2, ln_scale, ln_bias, w1, b1, w2, b2, eps: float,
                      gelu: str = "erf", partial: bool = False):
    """K3 on [T, D] rows of float32 or bfloat16: returns (out, pre-GELU
    hidden) in x2's dtype, GELU in ``kernel_impl(gelu)``'s form. Weights bf16, LN parameters and biases f32. The
    LN rows kernel writes LN(x) in bf16, the fc1 pass reads it, and the fc2
    pass adds the residual x. With ``partial`` (a model rank's shard, b2
    None) out is the float32 act w2^T, with no b2 and no residual."""
    T, D, H = _rows_geometry("LN-MLP", x2, w1)
    f32 = torch.float32
    _check_aligned("LN-MLP", x2)
    _check_operands("LN-MLP", x2.device,
                    *_weight_specs(w1, b1, w2, D, H, None if partial else b2),
                    ("ln_scale", ln_scale, (D,), f32),
                    ("ln_bias", ln_bias, (D,), f32))
    n16 = _ln_rows(x2, ln_scale, ln_bias, eps)
    out, hpre = _fwd_passes(n16, w1, b1, w2, None if partial else b2,
                            x2.dtype, True, resid=None if partial else x2,
                            gelu=gelu)
    kernels.LAUNCHES["ln_mlp_fwd"] += 1
    return out, hpre


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as a float32 result of operands in their own dtype (JAX's
    ``preferred_element_type=float32``). On the card a bf16 pair goes to one
    cuBLAS GEMM with a float32 output; on the CPU the operands are upcast,
    which is exact, since a product of two bf16 values fits a float32."""
    f32 = torch.float32
    if a.device.type == "cuda" and a.dtype == b.dtype != f32:
        return torch.mm(a, b, out_dtype=f32)
    return a.to(f32) @ b.to(f32)


# ------------------------------------------ the 'fres'/'lnfres' backward
def mlp_gelu_bwd_reference(dh, hpre, gelu: str = "erf"):
    """Plain version of the GELU-backward pass, the composite that the
    'fres' and 'lnfres' backwards run on the CPU: from dh [T, H] (float32)
    and the saved pre-GELU hidden hpre [T, H], (gh = dh gelu'(hpre), act =
    gelu(hpre)) in hpre's dtype, GELU in ``kernel_impl(gelu)``'s form, and
    db1 [H], the float32 column sums of the stored gh."""
    dt = hpre.dtype
    f32 = torch.float32
    act, grad = gelu_act_grad_f32(hpre.to(f32), kernel_impl(gelu))
    gh = (dh * grad).to(dt)
    return gh, act.to(dt), gh.to(f32).sum(dim=0)


def mlp_gelu_bwd_kernel(dh, hpre, gelu: str = "erf"):
    """The GELU-backward pass on the card (``csrc/mlp.cu``
    ``mlp_gelu_bwd_kernel``, then ``colsum_fold_kernel``): dh [T, H]
    float32, hpre [T, H] float32 or bfloat16 (H a multiple of 4); returns
    (gh, act) in hpre's dtype and db1 [H] float32, the column sums of the
    stored gh per ``GH_TILE``-row tile added in row-tile order."""
    f32 = torch.float32
    if (dh.device.type != "cuda" or dh.dim() != 2 or dh.dtype != f32
            or hpre.shape != dh.shape or hpre.dtype not in kernels.DTYPE_CODES
            or hpre.device != dh.device or not dh.is_contiguous()
            or not hpre.is_contiguous() or dh.shape[0] == 0
            or dh.shape[1] == 0 or dh.shape[1] % 4):
        raise ValueError(
            f"MLP GELU backward kernel takes a contiguous CUDA [T, H] float32 "
            f"dh and a hpre alike in float32 or bfloat16, T > 0, H a multiple "
            f"of 4; got {tuple(dh.shape)} {dh.dtype} on {dh.device}, "
            f"{tuple(hpre.shape)} {hpre.dtype} on {hpre.device}")
    _check_aligned("MLP GELU backward", dh, hpre)
    T, H = dh.shape
    gh = torch.empty_like(hpre)
    act = torch.empty_like(hpre)
    colsum = torch.empty((-(-T // GH_TILE), H), dtype=f32, device=dh.device)
    db1 = torch.empty((H,), dtype=f32, device=dh.device)
    err = kernels.library().avsiam_mlp_gelu_bwd(
        dh.data_ptr(), hpre.data_ptr(), gh.data_ptr(), act.data_ptr(),
        colsum.data_ptr(), db1.data_ptr(), T, H, kernels.DTYPE_CODES[hpre.dtype],
        KERNEL_CODES[kernel_impl(gelu)], kernels.stream_handle(dh))
    kernels.check(err, "MLP GELU backward pass")
    kernels.LAUNCHES["mlp_gelu_bwd"] += 1
    return gh, act, db1


def mlp_gelu_bwd(dh, hpre, gelu: str = "erf"):
    """The GELU-backward pass: its plain version on a CPU tensor, the kernel
    on a CUDA one."""
    if dh.device.type == "cpu":
        return mlp_gelu_bwd_reference(dh, hpre, gelu)
    return mlp_gelu_bwd_kernel(dh, hpre, gelu)


def _saved_hidden_bwd(inp, w1, w2, hpre, do, gelu: str, group=None):
    """Backward of ``fc2(gelu(fc1(inp)))`` from its saved pre-GELU hidden
    (``_fres_mlp_bwd``; hpre in inp's dtype): (d inp in inp's dtype, dw1,
    db1, dw2, db2). dh = do @ w2 stays in float32 until it meets gelu', as
    in the JAX package; the GELU-backward pass makes gh, act and db1 from
    it, and the products are cuBLAS's. With a model ``group`` d inp is the
    float32 sum of the ranks' partial products, cast after the sum."""
    gh, act, db1 = mlp_gelu_bwd(mm_f32(do, w2), hpre, gelu)
    if group is None:
        dinp = gh @ w1
    else:
        dinp = mm_f32(gh, w1)
        dist.all_reduce(dinp, group=group)
        dinp = dinp.to(inp.dtype)
    return dinp, gh.T @ inp, db1, do.T @ act, do.to(torch.float32).sum(dim=0)


def _row_parallel_out(partial, b2, group, dtype):
    """The fc2 output from the ranks' float32 partial products: summed over
    the group, b2 added in float32, then cast to ``dtype``."""
    dist.all_reduce(partial, group=group)
    return (partial + b2.to(torch.float32)).to(dtype)


class _LnMlp(torch.autograd.Function):
    """Forward: K3 (CUDA) or its plain version (CPU). Backward, as
    ``_lnfres_mlp_bwd``: LN(x) recomputed (K3's rows kernel on the card),
    ``_saved_hidden_bwd``, then the LayerNorm's VJP (K10 on the card, which
    raises on a width it does not take). With a model ``group``: K3's
    partial form, the sum over the group, then b2 and the residual once."""

    @staticmethod
    def forward(ctx, x2, ln_scale, ln_bias, w1, b1, w2, b2, eps, gelu,
                group):
        partial = group is not None
        if x2.device.type == "cpu":
            out, hpre = ln_mlp_reference(x2, ln_scale, ln_bias, w1, b1, w2,
                                         b2, eps, gelu, partial)
        else:
            f32 = torch.float32
            w1k, b1k, w2k, b2k = _kernel_weights(w1, b1, w2, b2)
            out, hpre = ln_mlp_fwd_kernel(
                x2, ln_scale.to(f32).contiguous(), ln_bias.to(f32).contiguous(),
                w1k, b1k, w2k, b2k, eps, gelu, partial)
        if partial:
            out = x2 + _row_parallel_out(out, b2, group, x2.dtype)
        ctx.save_for_backward(x2, ln_scale, ln_bias, w1, w2, hpre)
        ctx.eps, ctx.gelu, ctx.b1_dtype = eps, gelu, b1.dtype
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, do):
        x2, g, bln, w1, w2, hpre = ctx.saved_tensors
        eps = ctx.eps
        card = x2.device.type == "cuda"
        f32 = torch.float32
        gk, bk = g.to(f32).contiguous(), bln.to(f32).contiguous()
        # recompute the LN output: on the card the bf16 rows fc1 read
        n = (_ln_rows(x2, gk, bk, eps).to(x2.dtype) if card
             else layer_norm(x2, g, bln, eps))
        dn, dw1, db1, dw2, db2 = _saved_hidden_bwd(n, w1, w2, hpre, do,
                                                   ctx.gelu, ctx.group)
        if card:
            dx_ln, dgamma, dbeta = ln_bwd_kernel(x2, dn, gk, eps)
        else:
            dx_ln, dgamma, dbeta = layer_norm_vjp(x2, g, dn, eps)
        dx = do + dx_ln  # the residual branch's cotangent joins here
        return (dx, dgamma.to(g.dtype), dbeta.to(bln.dtype), dw1.to(w1.dtype),
                db1.to(ctx.b1_dtype), dw2.to(w2.dtype), db2.to(ctx.b1_dtype),
                None, None, None)


def fused_ln_mlp(x: torch.Tensor, ln_scale, ln_bias, w1, b1, w2, b2,
                 eps: float = 1e-5, gelu: str = "erf",
                 group=None) -> torch.Tensor:
    """``x + fc2(gelu(fc1(LN(x))))`` over x [..., D]. Parameters may be f32
    masters: the weights and biases are cast to x's dtype here (outside the
    autograd Function, so their gradients reach the masters in f32) and the
    LN parameters to f32. ``group``: the model group whose rank holds w1
    and b1's rows and w2's columns of the hidden width (module
    docstring)."""
    shape = x.shape
    dt = x.dtype
    f32 = torch.float32
    out = _LnMlp.apply(x.reshape(-1, shape[-1]), ln_scale.to(f32),
                       ln_bias.to(f32), w1.to(dt), b1.to(dt), w2.to(dt),
                       b2.to(dt), float(eps), gelu, group)
    return out.reshape(shape)


# ------------------------------------------------------------- K4
def mlp_fwd_reference(x2, w1, b1, w2, b2, gelu: str = "erf",
                      save_hpre: bool = False):
    """Plain version of K4 on [T, D] rows: out, or (out, pre-GELU hidden)
    with ``save_hpre``, in x2's dtype; products in float32 from the given
    values. b2 None: out is the float32 act w2^T alone (the partial
    form)."""
    dt = x2.dtype
    f32 = torch.float32
    hpre = x2.to(f32) @ w1.to(f32).T + b1.to(f32)
    act = gelu_f32(hpre, kernel_impl(gelu)).to(dt)
    out = mlp_fc2_reference(act, w2, b2)
    return (out, hpre.to(dt)) if save_hpre else out


def mlp_fwd_kernel(x2, w1, b1, w2, b2, save_hpre: bool = False,
                   gelu: str = "erf"):
    """K4 on [T, D] rows of float32 or bfloat16: out, or (out, pre-GELU
    hidden) with ``save_hpre``, in x2's dtype, GELU in
    ``kernel_impl(gelu)``'s form. Weights bf16, biases f32. An
    f32 call feeds the fc1 pass x cast to bf16 (the operand it multiplies
    in either storage). b2 None (a model rank's shard): out is the float32
    partial product act w2^T, with no bias."""
    T, D, H = _rows_geometry("MLP forward", x2, w1)
    _check_aligned("MLP forward", x2)
    _check_operands("MLP forward", x2.device,
                    *_weight_specs(w1, b1, w2, D, H, b2))
    out, hpre = _fwd_passes(x2.to(torch.bfloat16), w1, b1, w2, b2, x2.dtype,
                            save_hpre, gelu=gelu)
    kernels.LAUNCHES["mlp_fwd"] += 1
    return (out, hpre) if save_hpre else out


def mlp_fwd(x2, w1, b1, w2, b2, gelu: str = "erf", save_hpre: bool = False,
            group=None):
    """K4 on a CUDA tensor (weights cast to bf16, biases to f32), its plain
    version on a CPU tensor. With a model ``group``: the partial form, the
    sum over the group, then b2 once."""
    b2k = None if group is not None else b2
    if x2.device.type == "cpu":
        res = mlp_fwd_reference(x2, w1, b1, w2, b2k, gelu, save_hpre)
    else:
        w1k, b1k, w2k, b2k = _kernel_weights(w1, b1, w2, b2k)
        res = mlp_fwd_kernel(x2, w1k, b1k, w2k, b2k, save_hpre, gelu)
    if group is None:
        return res
    out, hpre = res if save_hpre else (res, None)
    out = _row_parallel_out(out, b2, group, x2.dtype)
    return (out, hpre) if save_hpre else out


# ---------------------------------------------------------- K7, K8, K9
def _recompute_gh(x2, w1, b1, w2, do, gelu: str):
    """(act, gh) of the backward that recomputes the hidden, in float32
    from the given values."""
    f32 = torch.float32
    hpre = x2.to(f32) @ w1.to(f32).T + b1.to(f32)
    act, grad = gelu_act_grad_f32(hpre, kernel_impl(gelu))
    return act, (do.to(f32) @ w2.to(f32)) * grad


def row_tile_sums(g: torch.Tensor, tile: int = GH_TILE) -> torch.Tensor:
    """The float32 column sums of each ``tile``-row tile of g [T, H]:
    [ceil(T / tile), H], rows past T counting as zeros."""
    T, H = g.shape
    pad = -T % tile
    gp = F.pad(g.to(torch.float32), (0, 0, 0, pad))
    return gp.view(-1, tile, H).sum(dim=1)


def fold_rows(parts: torch.Tensor) -> torch.Tensor:
    """The rows of ``parts`` added in row order, from zero (the gh pass's
    db1 fold)."""
    out = torch.zeros_like(parts[0])
    for p in parts:
        out = out + p
    return out


def mlp_gh_reference(x2, w1, b1, w2, do, gelu: str = "erf"):
    """Plain version of the gh pass of K7 and K8: (gh, act) in x2's dtype
    and the float32 column sums of the float32 gh per ``GH_TILE``-row tile
    ([ceil(T / GH_TILE), H]; K7 folds them into db1 with ``fold_rows``)."""
    dt = x2.dtype
    act, gh = _recompute_gh(x2, w1, b1, w2, do, gelu)
    return gh.to(dt), act.to(dt), row_tile_sums(gh)


def mlp_dx_reference(gh, w1, dtype=None):
    """Plain version of the dx pass: gh [T, H] @ w1 [H, D] in float32 from
    the given values, in ``dtype`` (gh's by default; float32 for a model
    rank's partial dx)."""
    f32 = torch.float32
    return (gh.to(f32) @ w1.to(f32)).to(dtype or gh.dtype)


def mlp_bwd_reference(x2, w1, b1, w2, do, gelu: str = "erf", dx_dtype=None):
    """Plain version of K7 (``_bwd_fused_kernel``), composed as the kernels
    compose it: dx in ``dx_dtype`` (x2's by default); dw1 [H, D], db1 [H],
    dw2 [D, H], db2 [D] in float32. dx and dw1 take gh in x2's dtype; db1
    is the fold of the float32 gh's row-tile sums; dw2 and db2 are K9's on
    (act, do)."""
    gh, act, parts = mlp_gh_reference(x2, w1, b1, w2, do, gelu)
    dw1, _ = weight_grads_reference(x2, gh)
    dw2, db2 = weight_grads_reference(act, do)
    return (mlp_dx_reference(gh, w1, dx_dtype), dw1, fold_rows(parts), dw2,
            db2)


def mlp_bwd_dx_reference(x2, w1, b1, w2, do, gelu: str = "erf",
                         dx_dtype=None):
    """Plain version of K8 (``_bwd_dx_kernel``): (dx in ``dx_dtype``, gh,
    act), gh and act in x2's dtype, as dx by default."""
    gh, act, _ = mlp_gh_reference(x2, w1, b1, w2, do, gelu)
    return mlp_dx_reference(gh, w1, dx_dtype), gh, act


def weight_grads_reference(a, g):
    """Plain version of K9 (``_dw_kernel``) on a [T, m], g [T, n]: (g^T a
    [n, m], the column sums of g [n]), in float32."""
    gf = g.to(torch.float32)
    return gf.T @ a.to(torch.float32), gf.sum(dim=0)


def _bwd_operands(name, x2, w1, b1, w2, do):
    T, D, H = _rows_geometry(name, x2, w1)
    _check_operands(name, x2.device, *_weight_specs(w1, b1, w2, D, H))
    if (do.shape != x2.shape or do.dtype != x2.dtype or do.device != x2.device
            or not do.is_contiguous()):
        raise ValueError(f"{name}: do must be a contiguous {tuple(x2.shape)} "
                         f"{x2.dtype} tensor on {x2.device}")
    _check_aligned(name, x2, do)
    return T, D, H


def _gh_pass(x2, w1, b1, w2, do, with_db1: bool, gelu: str = "erf"):
    """The gh pass on the card: (gh, act in x2's dtype, gh in bf16 for the
    dx pass, K7's db1 or None), GELU in ``kernel_impl(gelu)``'s form. An f32 call feeds the kernel x and do cast
    to bf16 (the operands it multiplies in either storage)."""
    T, D = x2.shape
    H = w1.shape[0]
    dev, bf16, f32 = x2.device, torch.bfloat16, torch.float32
    x16, do16 = x2.to(bf16), do.to(bf16)
    gh = torch.empty((T, H), dtype=x2.dtype, device=dev)
    act = torch.empty_like(gh)
    gh16 = gh if x2.dtype == bf16 else torch.empty((T, H), dtype=bf16,
                                                   device=dev)
    colsum = db1 = None
    if with_db1:
        colsum = torch.empty((-(-T // GH_TILE), H), dtype=f32, device=dev)
        db1 = torch.empty((H,), dtype=f32, device=dev)
    err = kernels.library().avsiam_mlp_bwd_gh(
        x16.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        do16.data_ptr(), gh.data_ptr(), act.data_ptr(), gh16.data_ptr(),
        None if colsum is None else colsum.data_ptr(),
        None if db1 is None else db1.data_ptr(), T, D, H,
        kernels.DTYPE_CODES[x2.dtype], KERNEL_CODES[kernel_impl(gelu)],
        kernels.stream_handle(x2))
    kernels.check(err, "MLP backward gh pass")
    return gh, act, gh16, db1


def _dx_pass(gh16, w1, dtype):
    """The dx pass on the card: gh16 [T, H] (bf16) @ w1 [H, D] in
    ``dtype``."""
    T, H = gh16.shape
    D = w1.shape[1]
    dev = gh16.device
    splits = dx_splits(T, D, H, kernels.num_sms(dev))
    dx = torch.empty((T, D), dtype=dtype, device=dev)
    partial = (torch.empty((splits, T, D), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    err = kernels.library().avsiam_mlp_bwd_dx(
        gh16.data_ptr(), w1.data_ptr(), dx.data_ptr(),
        None if partial is None else partial.data_ptr(), T, D, H, splits,
        kernels.DTYPE_CODES[dtype], kernels.stream_handle(gh16))
    kernels.check(err, "MLP backward dx pass")
    return dx


def mlp_bwd_kernel(x2, w1, b1, w2, do, gelu: str = "erf", dx_dtype=None):
    """K7 on [T, D] rows x2 and their cotangent do (float32 or bfloat16,
    alike; H a multiple of 128): (dx in ``dx_dtype``, x2's by default;
    dw1 [H, D], db1 [H], dw2 [D, H], db2 [D] in float32). Weights bf16, b1
    f32. The gh pass (db1 from the f32 gh), the dx pass, then K9 on (x, gh)
    and (act, do); K9's db1, from the stored gh, is not K7's and is
    dropped."""
    T, D, H = _bwd_operands("MLP backward", x2, w1, b1, w2, do)
    if H % WEIGHT_GRAD_TILE:
        raise ValueError(f"MLP backward takes H a multiple of "
                         f"{WEIGHT_GRAD_TILE} (K9's tiles), got H={H}")
    gh, act, gh16, db1 = _gh_pass(x2, w1, b1, w2, do, True, gelu)
    dx = _dx_pass(gh16, w1, dx_dtype or x2.dtype)
    kernels.LAUNCHES["mlp_bwd"] += 1
    dw1, _ = weight_grads_kernel(x2, gh)
    dw2, db2 = weight_grads_kernel(act, do)
    return dx, dw1, db1, dw2, db2


def mlp_bwd_dx_kernel(x2, w1, b1, w2, do, gelu: str = "erf", dx_dtype=None):
    """K8 on [T, D] rows x2 and their cotangent do: (dx [T, D] in
    ``dx_dtype``, gh [T, H], act [T, H]), gh and act in x2's dtype, as dx
    by default. Weights bf16, b1 f32. The gh pass, then the dx pass."""
    _bwd_operands("MLP backward dx", x2, w1, b1, w2, do)
    gh, act, gh16, _ = _gh_pass(x2, w1, b1, w2, do, False, gelu)
    dx = _dx_pass(gh16, w1, dx_dtype or x2.dtype)
    kernels.LAUNCHES["mlp_bwd_dx"] += 1
    return dx, gh, act


def weight_grads_kernel(a, g):
    """K9 on a [T, m] and g [T, n] (float32 or bfloat16, alike; m and n
    multiples of 128): (g^T a [n, m], the column sums of g [n]) in float32.
    bf16 sums db from the stored g, float32 from the unrounded g."""
    if a.device.type != "cuda":
        raise ValueError(f"weight-gradient kernel needs a CUDA tensor, got "
                         f"{a.device}")
    if (a.dim() != 2 or g.dim() != 2 or a.shape[0] != g.shape[0]
            or a.shape[0] == 0 or a.dtype not in kernels.DTYPE_CODES
            or g.dtype != a.dtype or g.device != a.device
            or not a.is_contiguous() or not g.is_contiguous()
            or a.shape[1] % WEIGHT_GRAD_TILE or g.shape[1] % WEIGHT_GRAD_TILE):
        raise ValueError(
            f"weight-gradient kernel takes contiguous [T, m], [T, n] float32 "
            f"or bfloat16 tensors alike, T > 0, m and n multiples of "
            f"{WEIGHT_GRAD_TILE}; got {tuple(a.shape)} {a.dtype}, "
            f"{tuple(g.shape)} {g.dtype}")
    _check_aligned("weight gradients", a, g)
    T, m = a.shape
    n = g.shape[1]
    tile = weight_grad_tile(m, n, kernels.num_sms(a.device))
    lib = kernels.library()
    dw = torch.empty((n, m), dtype=torch.float32, device=a.device)
    db = torch.empty((n,), dtype=torch.float32, device=a.device)
    err = lib.avsiam_mlp_dw(a.data_ptr(), g.data_ptr(), dw.data_ptr(),
                            db.data_ptr(), T, m, n, *tile,
                            kernels.DTYPE_CODES[a.dtype],
                            kernels.stream_handle(a))
    kernels.check(err, "weight gradients")
    kernels.LAUNCHES["mlp_dw"] += 1
    return dw, db


def weight_grads(a, g):
    """K9 on CUDA tensors, its plain version on CPU tensors."""
    if a.device.type == "cpu":
        return weight_grads_reference(a, g)
    return weight_grads_kernel(a, g)


def _recompute_bwd(x2, w1, b1, w2, do, gelu: str, group=None):
    """The backward of 'fused' and 'fbwd' from the saved (x, w1, b1, w2):
    K7, or under ``AVSIAM_MLP_BWD=split`` (read per call, as ``_bwd_call``
    does) K8 and then K9 for (dw1, db1) and for (dw2, db2). On a CPU tensor
    the plain versions. Returns (dx, dw1, db1, dw2, db2). With a model
    ``group`` the passes write the float32 partial dx, which is summed over
    the group and then cast to x2's dtype."""
    split = os.environ.get("AVSIAM_MLP_BWD") == "split"
    dx_dtype = None if group is None else torch.float32
    if x2.device.type == "cpu":
        if not split:
            grads = mlp_bwd_reference(x2, w1, b1, w2, do, gelu, dx_dtype)
        else:
            dx, gh, act = mlp_bwd_dx_reference(x2, w1, b1, w2, do, gelu,
                                               dx_dtype)
    else:
        w1k, b1k, w2k, _ = _kernel_weights(w1, b1, w2)
        if not split:
            grads = mlp_bwd_kernel(x2, w1k, b1k, w2k, do, gelu, dx_dtype)
        else:
            dx, gh, act = mlp_bwd_dx_kernel(x2, w1k, b1k, w2k, do, gelu,
                                            dx_dtype)
    if split:
        grads = (dx, *weight_grads(x2, gh), *weight_grads(act, do))
    if group is None:
        return grads
    dist.all_reduce(grads[0], group=group)
    return (grads[0].to(x2.dtype), *grads[1:])


# ------------------------------------------------------------- fused_mlp
class _FusedMlp(torch.autograd.Function):
    """'fused': K4 forward, no hidden saved; the backward recomputes it."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, gelu, group):
        ctx.save_for_backward(x2, w1, b1, w2)
        ctx.gelu, ctx.group = gelu, group
        return mlp_fwd(x2, w1, b1, w2, b2, gelu, group=group)

    @staticmethod
    def backward(ctx, do):
        x2, w1, b1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = _recompute_bwd(
            x2, w1, b1, w2, do.contiguous(), ctx.gelu, ctx.group)
        # the weight gradients come back in f32 and are cast to the
        # weights' dtype, as ``_fused_mlp_bwd`` does
        return (dx, dw1.to(w1.dtype), db1.to(w1.dtype), dw2.to(w2.dtype),
                db2.to(w2.dtype), None, None)


class _FbwdMlp(_FusedMlp):
    """'fbwd': the plain dense forward, bit for bit the 'dense' ``Mlp``
    (with the requested GELU, true 'erf'); the backward of 'fused'. With a
    model group fc2 is row-parallel: the float32 partial products summed,
    then b2."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, gelu, group):
        ctx.save_for_backward(x2, w1, b1, w2)
        ctx.gelu, ctx.group = gelu, group
        act = gelu_op(F.linear(x2, w1, b1), gelu)
        if group is None:
            return F.linear(act, w2, b2)
        return _row_parallel_out(mm_f32(act, w2.T), b2, group, x2.dtype)


class _FresMlp(torch.autograd.Function):
    """'fres': K4 forward saving the pre-GELU hidden; the backward from it
    is ``_saved_hidden_bwd`` (``_fres_mlp_bwd``)."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, gelu, group):
        out, hpre = mlp_fwd(x2, w1, b1, w2, b2, gelu, save_hpre=True,
                            group=group)
        ctx.save_for_backward(x2, w1, w2, hpre)
        ctx.gelu, ctx.group = gelu, group
        return out

    @staticmethod
    def backward(ctx, do):
        x2, w1, w2, hpre = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = _saved_hidden_bwd(x2, w1, w2, hpre, do,
                                                   ctx.gelu, ctx.group)
        return (dx, dw1.to(w1.dtype), db1.to(w1.dtype), dw2.to(w2.dtype),
                db2.to(w2.dtype), None, None)


_FUSED_FNS = {"fused": _FusedMlp, "fbwd": _FbwdMlp, "fres": _FresMlp}


def fused_mlp(x: torch.Tensor, w1, b1, w2, b2, gelu: str = "erf",
              impl: str = "fused", group=None) -> torch.Tensor:
    """``fc2(gelu(fc1(x)))`` over x [..., D] with impl 'fused', 'fbwd' or
    'fres' (module docstring). Parameters may be f32 masters: weights and
    biases are cast to x's dtype here, outside the autograd Function, so
    their gradients reach the masters in f32. ``group``: the model group
    whose rank holds this shard of the hidden width."""
    if impl not in FUSED_IMPLS:
        raise ValueError(f"fused_mlp impl {impl!r} not in {FUSED_IMPLS}")
    shape = x.shape
    dt = x.dtype
    out = _FUSED_FNS[impl].apply(x.reshape(-1, shape[-1]), w1.to(dt),
                                 b1.to(dt), w2.to(dt), b2.to(dt), gelu,
                                 group)
    return out.reshape(shape)
