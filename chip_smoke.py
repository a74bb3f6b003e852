#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``avsiam_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: the card's name and power limit, as nvidia-smi reports them.
2. kernels: builds the CUDA kernels from ``avsiam_tpu_torch/csrc`` with nvcc,
   then holds each kernel against its plain PyTorch version at every shape
   the step phases give it (bf16 inputs; the plain version runs in float32
   on the same values), the MLP kernels also at ViT-L's and ViT-H's widths,
   K1/K2 also at phase P64's masked encoder shapes under the keep masks
   'padded' draws,
   and times kernel, plain version and, where one PyTorch call computes the
   same function (``F.scaled_dot_product_attention`` for attention,
   ``torch.mm`` with a float32 output for the weight gradient,
   ``native_layer_norm_backward`` for the LN backward), that call as a
   yardstick the port never calls; for K3, K4, K7 and K8, which no one call
   computes, the 'dense' form's cuBLAS GEMMs and elementwise ops on the same
   operands (a composite yardstick). Each time is device time per call,
   from torch.profiler; K3's and K4's also by pass (LN rows, fc1, fc2,
   partial-sum epilogue), K7's likewise, with per-step totals. A kernel
   that spills registers fails the run. Every kernel of phases A64, P64,
   H64 and F is also held, untimed, at those steps' shapes. K3, K4, K7 and
   K8 also under each GELU form the kernels run ('ans', 'tanh', 'cheb',
   'tanh5'), at phase A's largest encoder rows, each timed, and in
   float32 storage K8's act and gh from K4's hpre within 1e-4 of the asked
   form and nearer it than any other form float32 tells apart; K1/K2 at head
   widths 8, 16 and 128 (C 128, 128, 256) and K5/K6 at 8, 16, 48 and 128,
   with and without masked keys.
   Then the data layer on the card: ``kaldi_fbank`` against
   ``tests/fixtures/fbank_golden.npz`` over the golden waveforms (atol
   5e-3, rtol 5e-4), and the train transform under the finetune recipes'
   augmentations (freqm 48, timem 192, mixup 0.5, noise) at B=8 against
   the port's plain transform on the CPU from the same draws (masks and
   rolls equal, values within 5e-3); PD64's data pieces timed alone.
3. steps: full-width two-pass pretrain steps (bf16 compute, batch 8 unless
   named) from the port's own seeded init, 'exact' contrastive form unless
   named, in these configurations:
   A. ViT-B/16 (depth 12, decoder depth 8), ``mlp_impl='lnfres'`` (the
      bench configuration: K1, K2, K3);
   B. ViT-B, ``mlp_impl='fused'`` (K1, K2, K4 forward, K7 backward, which
      runs K9 twice);
   C. ViT-B, ``mlp_impl='fbwd'``, ``dec_mlp_impl='fres'`` and
      ``AVSIAM_MLP_BWD=split`` (K1, K2; K8 and K9 in the encoders' backward,
      K4 with the saved hidden in the decoder);
   D. ViT-B, ``mlp_impl='lnfres'`` under ``AVSIAM_LN=pallas`` (K1, K2, K3,
      and K10 in every LayerNormFP32 backward);
   E. ViT-H/16 (``pretrain_config('cav-mae-huge')``: dim 1280, depth 32,
      16 heads of 80; decoder 512/8/16), ``attn_impl='pallas'``,
      ``mlp_impl='fused'`` (K5, K6 in the encoders, K1, K2 in the decoder;
      K4 and K7, with K9, at D 1280 and in the decoder);
   A64. A at the JAX bench's batch of 64 (``bench.py:81-84``);
   P64. A64 in the 'padded' form, the JAX config's default (K1/K2 with a
      key mask per sample at full length, K3);
   H64. E at B=64 with ``remat_blocks`` (K5, K6; K1, K2 in the decoder;
      K4, K7, K9; the encoders' forward kernels run again in the backward);
   F. A in the 'tconcat', 'bucketed' and 'packed' forms ('packed' runs
      K4, not K3, in the encoders).
   Each phase runs the eager step (``make_pretrain_step``: five steps in
   A-D, three in E, A64 and P64, two in H64 and F) and then, on the same
   state, the step as one
   CUDA graph (``make_graphed_pretrain_step``: a warm-up step, the
   capture, which replays once, and as many timed replays). Every metric
   must be finite. Each kernel's launch count, reset just before the eager
   steps and read just after them, must equal what the step's shapes
   imply, and so must the counts the capture added. After each run one
   more step under torch.profiler: device time by kernel group, the
   device's busy share of a step, and each kernel's calls; a profiled
   replay must call every kernel of the port as often as the profiled
   eager step does (a replay runs no wrapper, so this is what shows the
   graph ran them). After phases A and P64, two states from one seed take
   three eager and three graphed steps: metrics, parameters and Adam
   moments must agree within 1e-5 relative (the same bits are expected).
   Then, on one set of 'exact' draws at B=8, each other form's pooled
   contrastive outputs must be within 2e-2 relative of 'exact''s ('padded'
   given the keep masks of those draws).
   PD64. P64's graphed step fed by the port's loader (``device_loader``
   over an ``AVDataset`` of 'synthetic' clips, the pretrain recipe's audio
   config): warm-up and capture, the loader's lead drained, then a window
   of 40 data-fed replays timed as one span (rate, loader wait, each
   half), the launch counts (from 0 just before, P64's per step), a
   profiled data-fed step (busy share), beside P64 on random batches. The
   host's assembly of one batch, and the device time of its copy to the
   card, the draws and the transform, are timed alone with the kernel
   checks.
4. reference: for configurations A-E, P64 and H64, one contrastive and one MAE
   forward/backward at full width, depth 1, batch 2, through the kernels in
   bf16 on the card and through the plain versions in float32 on the CPU,
   from the same weights and draws: losses and gradients must agree within
   the stated tolerances.

Before the last lines comes a JSON object of each step phase's eager and
graphed steady step, busy share, kernels, Adam's device time and peak
memory. The line before the last is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``. ``--report PATH`` also writes
the per-shape measurements as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12    # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
ATTN_TOL = 2e-2           # max |kernel - plain| / max |plain|, bf16 storage
MLP_TOL = 2e-2
LN_TOL = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3, by_kernel: bool = False):
    """Device time of one call of ``fn``: the summed time of every kernel and
    copy it runs on the card, over ``iters`` calls under torch.profiler,
    divided by ``iters`` (with ``by_kernel``, a dict of it by kernel name).
    The host's issue time between kernels is not counted, so a call shorter
    than it (about 40 us through ctypes) still reads its own device time;
    CUDA events around back-to-back calls would read the host's issue rate
    there.

    The profiler keeps the device records that fall inside its window on the
    host's clock. Late in a long run, sessions whose calls took well under a
    millisecond came back with none, three times in a row; so each session
    pads its window with a pause on each side. Every call runs the same
    kernels, so a session whose kernel count is no multiple of ``iters``
    lost records; it is run again with four times the pause, up to three
    sessions in all."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pause = 0.02
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pause)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(pause)
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        count = sum(e.count for e in device)
        if count and count % iters == 0:
            break
        pause *= 4
    if not count:
        raise AssertionError("the profiler recorded no device time")
    if count % iters:
        log(f"  note: {count} device records over {iters} calls")
    per = {}
    for e in device:
        per[e.key] = (per.get(e.key, 0.0)
                      + e.self_device_time_total / 1e3 / iters)
    return per if by_kernel else sum(per.values())


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes


def rel_err(got: torch.Tensor, ref: torch.Tensor):
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(ref.float().abs().max().item(), 1e-6)
    if not math.isfinite(err):
        raise AssertionError("non-finite kernel output")
    return err, err / scale


# ------------------------------------------------------------------ build
# kernels whose design keeps its tiles or rows in registers, a spill would
# undo it: every attention kernel (K1, K2, K5, K6), K10's two and every MLP
# kernel (K3, K4, the gh and dx passes of K7/K8, K9, their epilogues)
NO_SPILL = ("attn_", "ln_bwd_", "ln_mlp_", "mlp_", "colsum_fold")


def kernel_resources(build_log: str):
    """Each kernel's registers, spill bytes and stack from the compilers'
    ``-Xptxas -v`` report in the build log, with its name demangled where
    ``c++filt`` is installed."""
    import re
    import shutil
    rows, name, frame = [], None, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, frame = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            stack, stores, loads = frame or (0, 0, 0)
            rows.append(dict(name=name, registers=int(m.group(1)),
                             spill_stores=stores, spill_loads=loads,
                             stack=stack))
            name = None
    cxxfilt = shutil.which("c++filt")
    if rows and cxxfilt:
        out = subprocess.run([cxxfilt], input="\n".join(r["name"] for r in rows),
                             capture_output=True, text=True).stdout.splitlines()
        if len(out) == len(rows):
            for r, n in zip(rows, out):
                n = n.replace("(anonymous namespace)::", "")
                r["name"] = re.sub(r"^void |\(.*$", "", n)
    return rows


# ------------------------------------------------------------------ shapes
class Shapes(NamedTuple):
    """The kernel-call shapes of one pretrain step (``main_path_shapes``)
    and their calls per step."""

    attn: dict  # {(b, N, H, D): calls}
    mlp: dict  # {(rows, D, H, mlp_impl as mlp_route resolves it): calls}
    ln: dict  # {(rows, C): LayerNormFP32 calls}
    again_attn: dict  # the forward calls remat runs again in the backward
    again_mlp: dict
    masked: set  # the attention shapes that run with a key mask


def main_path_shapes(cfg, batch: int) -> Shapes:
    """Distinct (kernel-call) shapes of one pretrain step and their calls per
    step, in the configuration's contrastive form: each block call's
    attention and MLP sub-block, and the LayerNormFP32 calls (each block
    call's norm1, and its norm2 unless K3 folds it in; the encoders' final
    norms and the decoder's). Pass 1 by form: 'exact' each chunk at its keep
    counts, 'bucketed' at those rounded up to 128 (masked where padded),
    'padded' the whole batch at full length (masked), 'tconcat' attention
    per chunk and the MLP over all of a modality's rows, 'packed' attention
    per chunk and one 'fres' MLP (not the LN-folded sub-block) over both
    modalities' rows, its norms routed per modality. Under
    ``remat_blocks`` each trunk-block call's forward kernels run again in
    the backward (not 'tconcat''s or 'packed''s, which call the blocks'
    parts, nor ``mm_layer_1/2``'s or the decoder's)."""
    from avsiam_tpu_torch.models.cavmae import chunk_sizes
    from avsiam_tpu_torch.models.layers import mlp_route
    from avsiam_tpu_torch.ops.masking import len_keep_for
    m = cfg.model
    v, d = m.vit, m.decoder
    La, Lv = v.num_audio_tokens, v.num_video_tokens
    C, heads = v.dim, v.num_heads
    enc_h, dec_h = v.dim * int(v.mlp_ratio), d.dim * int(d.mlp_ratio)
    dec_impl = m.dec_mlp_impl or m.mlp_impl
    remat = m.remat_blocks
    s = Shapes({}, {}, {}, {}, {}, set())

    def count(table, key, calls):
        table[key] = table.get(key, 0) + calls

    def attention(b, n, heads, dim, calls, again=False, masked=False):
        key = (b, n, heads, dim // heads)
        count(s.attn, key, calls)
        if again:
            count(s.again_attn, key, calls)
        if masked:
            s.masked.add(key)

    def mlp(rows, dim, hidden, calls, impl, again=False):
        key = (rows, dim, hidden, mlp_route(impl, dim, hidden))
        count(s.mlp, key, calls)
        if again:
            count(s.again_mlp, key, calls)
        count(s.ln, (rows, dim), calls * (1 if key[3] == "lnfres" else 2))

    def block(b, n, heads, dim, hidden, calls, impl=m.mlp_impl, again=False,
              masked=False):
        attention(b, n, heads, dim, calls, again, masked)
        mlp(b * n, dim, hidden, calls, impl, again)

    sizes = chunk_sizes(batch, m.mmixed_num_chunks)  # pass 1: contrastive
    keeps = [(len_keep_for(La, m.mmixed_ratio_step * i),
              len_keep_for(Lv, m.mmixed_ratio_step * i))
             for i in range(len(sizes))]
    form = m.mmixed_impl
    if form == "padded":
        for n in (La, Lv):
            block(batch, n, heads, C, enc_h, v.depth, again=remat,
                  masked=True)
            count(s.ln, (batch * n, C), 1)
    elif form in ("exact", "bucketed"):
        for size, keep in zip(sizes, keeps):
            for k in keep:
                n = -(-k // 128) * 128 if form == "bucketed" else k
                block(size, n, heads, C, enc_h, v.depth, again=remat,
                      masked=n != k)
                count(s.ln, (size * n, C), 1)
    else:
        rows = [sum(b * keep[i] for b, keep in zip(sizes, keeps))
                for i in (0, 1)]
        for size, keep in zip(sizes, keeps):
            for k in keep:
                attention(size, k, heads, C, v.depth)
        if form == "tconcat":
            for r in rows:
                mlp(r, C, enc_h, v.depth, m.mlp_impl)
                count(s.ln, (r, C), 1)
        else:  # 'packed': ``Mlp``, where 'lnfres' is 'fres'
            impl = mlp_route(m.mlp_impl, C, enc_h)
            count(s.mlp, (sum(rows), C, enc_h,
                          "fres" if impl == "lnfres" else impl), v.depth)
            for r in rows:  # norm1, norm2 and the final norm, routed
                count(s.ln, (r, C), 2 * v.depth + 1)
    ka = len_keep_for(La, m.mae_mask_ratio)  # pass 2: MAE
    kv = len_keep_for(Lv, m.mae_mask_ratio)
    for n in (ka, kv):
        block(batch, n, heads, C, enc_h, v.depth, again=remat)
        count(s.ln, (batch * n, C), 1)
    block(batch, ka + kv, heads, C, enc_h, 2)
    block(batch, La + Lv, d.num_heads, d.dim, dec_h, d.depth, dec_impl)
    count(s.ln, (batch * (La + Lv), d.dim), 1)
    return s


def mlp_call_launches(impl: str, split: bool) -> dict:
    """Kernel launches of one MLP sub-block call, forward and backward, in
    a block's ``mlp_impl`` as ``mlp_route`` resolves it ('lnfres' folds the
    LN into K3 on the card; 'fres' and 'dense' have backwards of PyTorch
    ops). K7 and the split backward (K8) each run K9 twice."""
    out = {}
    if impl == "lnfres":
        out["ln_mlp_fwd"] = 1
    elif impl in ("fused", "fres"):
        out["mlp_fwd"] = 1
    if impl in ("fused", "fbwd"):
        out.update({"mlp_bwd_dx" if split else "mlp_bwd": 1, "mlp_dw": 2})
    return out


# the kernels an MLP sub-block's forward launches (what remat runs again)
MLP_FWD_KERNELS = ("ln_mlp_fwd", "mlp_fwd")


def mlp_shape_launches(mlp_shapes, split: bool):
    """{(rows, D, H): {kernel: launches per step}} of one configuration."""
    out = {}
    for (t, d, h, impl), calls in mlp_shapes.items():
        row = out.setdefault((t, d, h), {})
        for k, n in mlp_call_launches(impl, split).items():
            row[k] = row.get(k, 0) + n * calls
    return out


ATTN_KERNELS = {"token_major": ("attention_fwd", "attention_bwd"),
                "head_major": ("attention_hm_fwd", "attention_hm_bwd"),
                "xla": ()}


def expected_launches(cfg, shapes: Shapes, split: bool, ln_pallas: bool,
                      n_steps: int):
    """Each kernel's launches over ``n_steps`` steps, from the shapes
    (``main_path_shapes``): attention by ``attention_route``, the MLP by
    impl, the forward kernels of the calls remat runs again once more, K10
    at every LayerNormFP32 call of a width it takes under
    ``AVSIAM_LN=pallas``."""
    from avsiam_tpu_torch import kernels
    from avsiam_tpu_torch.ops.attention import attention_route
    out = {k: 0 for k in kernels.LAUNCHES}
    for table, which in ((shapes.attn, slice(None)),
                         (shapes.again_attn, slice(0, 1))):
        for (_, _, heads, hd), calls in table.items():
            route = attention_route(cfg.model.attn_impl, heads * hd, heads)
            for k in ATTN_KERNELS[route][which]:
                out[k] += calls * n_steps
    for row in mlp_shape_launches(shapes.mlp, split).values():
        for k, n in row.items():
            out[k] += n * n_steps
    for row in mlp_shape_launches(shapes.again_mlp, split).values():
        for k, n in row.items():
            if k in MLP_FWD_KERNELS:
                out[k] += n * n_steps
    if ln_pallas:
        out["ln_bwd"] = n_steps * sum(c for (_, C), c in shapes.ln.items()
                                      if C % 128 == 0)
    return out


def head_major_shapes(cfg, attn_shapes):
    """The attention shapes that ``cfg``'s attn_impl sends to K5/K6."""
    from avsiam_tpu_torch.ops.attention import attention_route
    return {k: c for k, c in attn_shapes.items()
            if attention_route(cfg.model.attn_impl, k[2] * k[3], k[2])
            == "head_major"}


# ------------------------------------------------------------ kernel phase
def random_key_mask(b: int, n: int, gen) -> torch.Tensor:
    """[b, n] bool, about 70% of the keys valid, key 0 always."""
    kv = torch.rand((b, n), generator=gen, device="cuda") > 0.3
    kv[:, 0] = True
    return kv


def check_attention(shapes, extra, gen, masks=None):
    """K1 and K2 at each (b, N, H, D) of ``shapes`` ({shape: calls per
    step}; under the key mask ``masks`` gives the shape, if any) and of
    ``extra`` ([(shape, masked)]: a random mask where masked), against their
    plain versions in float32 on the same values; times of kernel, plain
    version and SDPA on the same bf16 q, k, v and boolean mask, and the
    bound, which counts the products of the valid keys only."""
    import torch.nn.functional as F
    from avsiam_tpu_torch.ops.attention import (attention_bwd_kernel,
                                                attention_fwd_kernel,
                                                attention_hm_stats_reference,
                                                attention_reference)
    masks = masks or {}
    rows = []
    for (b, n, heads, hd), calls, masked in (
            [(k, c, masks.get(k, False)) for k, c in shapes.items()]
            + [(k, 0, m) for k, m in extra]):
        C = heads * hd
        xqkv = torch.randn((b, n, 3 * C), generator=gen, device="cuda"
                           ).to(torch.bfloat16)
        dout = torch.randn((b, n, C), generator=gen, device="cuda"
                           ).to(torch.bfloat16)
        kv = None
        if isinstance(masked, torch.Tensor):
            kv, masked = masked, True
        elif masked:
            kv = random_key_mask(b, n, gen)
        out, stats = attention_fwd_kernel(xqkv, heads, kv)
        dqkv = attention_bwd_kernel(xqkv, out, stats, dout, heads, kv)
        torch.cuda.synchronize()
        x32 = xqkv.float().requires_grad_(True)
        ref = attention_reference(x32, heads, kv)
        (gref,) = torch.autograd.grad(ref, x32, dout.float())
        ferr, frel = rel_err(out, ref)
        berr, brel = rel_err(dqkv, gref)
        # the saved max and 1/denominator, each against its own scale
        qf, kf, _ = xqkv.float().view(b, n, 3, heads, hd).unbind(2)
        want_st = attention_hm_stats_reference(qf, kf, kv)
        srel = max(rel_err(stats[..., i], want_st[..., i])[1] for i in (0, 1))
        if max(frel, brel, srel) > ATTN_TOL:
            raise AssertionError(
                f"attention b={b} N={n} H={heads} D={hd} masked={masked}: "
                f"fwd rel err {frel:.3e}, stats {srel:.3e}, bwd rel err "
                f"{brel:.3e} > {ATTN_TOL}")
        q, k, v = (t.transpose(1, 2).contiguous() for t in
                   xqkv.reshape(b, n, 3, heads, hd).unbind(2))
        mask = None if kv is None else kv[:, None, None, :]
        fwd_ms = time_ms(lambda: attention_fwd_kernel(xqkv, heads, kv))
        bwd_ms = time_ms(lambda: attention_bwd_kernel(xqkv, out, stats, dout,
                                                      heads, kv))
        plain_fwd = time_ms(lambda: attention_reference(xqkv.float(), heads, kv))
        ref_g = attention_reference(x32, heads, kv)
        plain_bwd = time_ms(lambda: torch.autograd.grad(
            ref_g, x32, dout.float(), retain_graph=True))
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask))
        do_t = dout.reshape(b, n, heads, hd).transpose(1, 2)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), do_t, retain_graph=True))
        # operations: q k^T and p v forward; backward adds the recomputed
        # q k^T, do v^T, dv, dq and dk, over the valid keys of each sample.
        # Bytes (bf16, stats f32): forward reads qkv, writes out and stats;
        # backward reads qkv, out, dout and stats and writes dqkv.
        keys = b * n if kv is None else int(kv.sum())
        sq = heads * n * keys * hd
        tok = b * n * C * 2  # one [B, N, C] bf16 tensor
        st = b * heads * n * 8
        fb = bound_ms(4 * sq, 3 * tok + tok + st)
        bb = bound_ms(10 * sq, 3 * tok + 2 * tok + st + 3 * tok)
        rows.append(dict(b=b, N=n, H=heads, D=hd, masked=masked,
                         valid_keys=keys, calls=calls, fwd_err=ferr,
                         fwd_rel=frel, stats_rel=srel, bwd_err=berr,
                         bwd_rel=brel,
                         fwd_ms=fwd_ms, bwd_ms=bwd_ms, plain_fwd_ms=plain_fwd,
                         plain_bwd_ms=plain_bwd, lib_fwd_ms=lib_fwd,
                         lib_bwd_ms=lib_bwd, fwd_bound=fb, bwd_bound=bb))
        log(f"  attention b={b:3d} N={n:4d} H={heads:2d} D={hd} "
            f"mask={int(masked)} x{calls:3d}/step  fwd err {ferr:.2e} "
            f"(rel {frel:.1e} <= {ATTN_TOL}; stats {srel:.1e}) {fwd_ms:.4f} "
            f"ms plain {plain_fwd:.4f} sdpa {lib_fwd:.4f} ({fwd_ms / lib_fwd:.2f}x) bound {fb[0]:.4f} "
            f"({100 * fb[0] / fwd_ms:.1f}%) | bwd err "
            f"{berr:.2e} (rel {brel:.1e}) {bwd_ms:.4f} ms plain "
            f"{plain_bwd:.4f} sdpa {lib_bwd:.4f} ({bwd_ms / lib_bwd:.2f}x) "
            f"bound {bb[0]:.4f} ({100 * bb[0] / bwd_ms:.1f}%)")
    return rows


def dense_ln_mlp(x, g, bl, w1, b1, w2, b2, eps: float):
    """K3's composite yardstick, the 'dense' form on the same bf16 operands:
    the LN in float32, two cuBLAS GEMMs with the float32 GELU between them,
    the residual add in bf16."""
    import torch.nn.functional as F
    from avsiam_tpu_torch.ops.gelu import gelu_f32
    from avsiam_tpu_torch.ops.layernorm import layer_norm
    n = layer_norm(x, g, bl, eps)
    act = gelu_f32(F.linear(n, w1, b1.bfloat16()).float(), "ans").bfloat16()
    return x + F.linear(act, w2, b2.bfloat16())


# the forward's kernels (K3, K4) by name fragment: LN rows, the fc1 and fc2
# passes, the partial-sum epilogue
FWD_PASSES = (("ln", "ln_mlp_rows"), ("fc1", "mlp_fc1"), ("fc2", "mlp_fc2"),
              ("epi", "mlp_epilogue"))


def fwd_pass_ms(parts):
    """{pass: ms} of a K3/K4 call from ``time_ms(..., by_kernel=True)``."""
    return {k: sum(t for n, t in parts.items() if frag in n)
            for k, frag in FWD_PASSES}


def fmt_passes(split):
    return " ".join(f"{k} {v:.4f}" for k, v in split.items() if v)


def check_ln_mlp(shapes, gen, eps: float = 1e-5):
    """K3 at each (rows, D, H) of ``shapes`` ({(rows, D, H, impl): calls
    per step}) against its plain version; times of kernel (and of its
    passes), plain version and the composite 'dense' yardstick (not one
    call), and their sums over a phase-A step."""
    from avsiam_tpu_torch.ops.mlp import ln_mlp_fwd_kernel, ln_mlp_reference
    rows = []
    for (t, d, h, _), calls in shapes.items():
        bf = torch.bfloat16

        def rnd(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * scale

        x = rnd(t, d).to(bf)
        g = 1.0 + rnd(d, scale=0.1)
        bl = rnd(d, scale=0.1)
        w1 = rnd(h, d, scale=d ** -0.5).to(bf)
        w2 = rnd(d, h, scale=h ** -0.5).to(bf)
        b1 = rnd(h, scale=0.02).to(bf).float()
        b2 = rnd(d, scale=0.02).to(bf).float()
        out, hpre = ln_mlp_fwd_kernel(x, g, bl, w1, b1, w2, b2, eps)
        torch.cuda.synchronize()
        ref, href = ln_mlp_reference(x.float(), g, bl, w1.float(), b1,
                                     w2.float(), b2, eps)
        oerr, orel = rel_err(out, ref)
        herr, hrel = rel_err(hpre, href)
        if orel > MLP_TOL or hrel > MLP_TOL:
            raise AssertionError(f"ln_mlp T={t} D={d}: out rel err {orel:.3e},"
                                 f" hidden rel err {hrel:.3e} > {MLP_TOL}")
        parts = time_ms(lambda: ln_mlp_fwd_kernel(x, g, bl, w1, b1, w2, b2,
                                                  eps), by_kernel=True)
        ms, split = sum(parts.values()), fwd_pass_ms(parts)
        plain = time_ms(lambda: ln_mlp_reference(x.float(), g, bl, w1.float(),
                                                 b1, w2.float(), b2, eps))
        composite = time_ms(lambda: dense_ln_mlp(x, g, bl, w1, b1, w2, b2,
                                                 eps))
        bd = bound_ms(4 * t * d * h, 2 * (2 * t * d + 2 * d * h + t * h))
        rows.append(dict(T=t, D=d, H=h, calls=calls, out_err=oerr,
                         out_rel=orel, hpre_err=herr, hpre_rel=hrel, ms=ms,
                         pass_ms=split, plain_ms=plain,
                         composite_ms=composite, bound=bd))
        log(f"  ln_mlp T={t:5d} D={d} H={h} x{calls:3d}/step  err out "
            f"{oerr:.2e} (rel {orel:.1e} <= {MLP_TOL}) hidden {herr:.2e} "
            f"(rel {hrel:.1e})  {ms:.4f} ms [{fmt_passes(split)}]"
            f" plain {plain:.4f} composite {composite:.4f} "
            f"({ms / composite:.2f}x) bound {bd[0]:.4f} "
            f"({100 * bd[0] / ms:.1f}%)")
    tot = {k: sum(r[k] * r["calls"] for r in rows)
           for k in ("ms", "composite_ms", "plain_ms")}
    split = {k: sum(r["pass_ms"][k] * r["calls"] for r in rows)
             for k, _ in FWD_PASSES}
    log(f"  ln_mlp fwd per phase-A step: {tot['ms']:.3f} ms "
        f"[{fmt_passes(split)}], composite {tot['composite_ms']:.3f}, plain "
        f"{tot['plain_ms']:.3f}, bound "
        f"{sum(r['bound'][0] * r['calls'] for r in rows):.3f}")
    return rows


def mlp_operands(gen, t: int, d: int, h: int):
    """bf16 rows x and cotangent do, bf16 weights in nn.Linear's layout, f32
    biases rounded to bf16 values (as the kernels take them)."""
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    return dict(x=rnd(t, d).to(bf), w1=rnd(h, d, scale=d ** -0.5).to(bf),
                b1=rnd(h, scale=0.02).to(bf).float(),
                w2=rnd(d, h, scale=h ** -0.5).to(bf),
                b2=rnd(d, scale=0.02).to(bf).float(), do=rnd(t, d).to(bf))


def dense_mlp_fwd(x, w1, b1, w2, b2):
    """K4's composite yardstick: two cuBLAS GEMMs with the float32 GELU
    between them, on the same bf16 operands."""
    import torch.nn.functional as F
    from avsiam_tpu_torch.ops.gelu import gelu_f32
    act = gelu_f32(F.linear(x, w1, b1.bfloat16()).float(), "ans").bfloat16()
    return F.linear(act, w2, b2.bfloat16())


def dense_mlp_bwd(x, w1, b1, w2, do, weights: bool):
    """K8's (``weights`` False) and K7's composite yardstick: the dense
    backward's GEMMs (float32 outputs where the kernels keep float32) and
    elementwise ops on the same bf16 operands."""
    from avsiam_tpu_torch.ops.gelu import gelu_act_grad_f32
    f32 = torch.float32
    hpre = torch.mm(x, w1.t(), out_dtype=f32) + b1
    act, grad = gelu_act_grad_f32(hpre, "ans")
    gh32 = torch.mm(do, w2, out_dtype=f32) * grad
    gh, act = gh32.bfloat16(), act.bfloat16()
    dx = gh @ w1
    if not weights:
        return dx, gh, act
    return (dx, torch.mm(gh.t(), x, out_dtype=f32), gh32.sum(dim=0),
            torch.mm(do.t(), act, out_dtype=f32), do.float().sum(dim=0))


def check_mlp_family(phase_calls, extra, gen):
    """K4 (with and without the pre-GELU hidden), K7, K8 and K9 at every
    (rows, D, H) of phases B, C and E and at ``extra`` shapes (no calls),
    against their plain versions in float32 on the same values (K7's db1
    against the plain f32-gh fold); times of kernel (K4 and K7 also by
    pass), plain
    version, the composite 'dense' yardstick (not one call) and, for K9,
    ``torch.mm`` (float32 and bf16 output). ``phase_calls`` maps B, C and E
    to their ``mlp_shape_launches``."""
    from avsiam_tpu_torch.ops import mlp as pm
    calls_b, calls_c, calls_e = (phase_calls[p] for p in "BCE")
    rows = []
    for t, d, h in sorted(set(calls_b) | set(calls_c) | set(calls_e)
                          | set(extra), key=lambda k: (k[1], -k[0])):
        o = mlp_operands(gen, t, d, h)
        x, w1, b1, w2, b2, do = (o[k] for k in ("x", "w1", "b1", "w2", "b2",
                                                "do"))
        f = {k: v.float() for k, v in o.items()}
        errs = {}

        def hold(name, got, want):
            for i, (g, w) in enumerate(zip(got, want)):
                errs[f"{name}[{i}]"] = rel_err(g, w)

        hold("fwd", [pm.mlp_fwd_kernel(x, w1, b1, w2, b2)],
             [pm.mlp_fwd_reference(f["x"], f["w1"], b1, f["w2"], b2)])
        hold("fwd_hpre", pm.mlp_fwd_kernel(x, w1, b1, w2, b2, True),
             pm.mlp_fwd_reference(f["x"], f["w1"], b1, f["w2"], b2,
                                  save_hpre=True))
        hold("bwd", pm.mlp_bwd_kernel(x, w1, b1, w2, do),
             pm.mlp_bwd_reference(f["x"], f["w1"], b1, f["w2"], f["do"]))
        dx, gh, act = pm.mlp_bwd_dx_kernel(x, w1, b1, w2, do)
        hold("bwd_dx", (dx, gh, act),
             pm.mlp_bwd_dx_reference(f["x"], f["w1"], b1, f["w2"], f["do"]))
        hold("dw1", pm.weight_grads_kernel(x, gh),
             pm.weight_grads_reference(f["x"], gh.float()))
        hold("dw2", pm.weight_grads_kernel(act, do),
             pm.weight_grads_reference(act.float(), f["do"]))
        torch.cuda.synchronize()
        worst = max(errs, key=lambda k: errs[k][1])
        if errs[worst][1] > MLP_TOL:
            raise AssertionError(f"mlp T={t} D={d} H={h}: {worst} rel err "
                                 f"{errs[worst][1]:.3e} > {MLP_TOL}")
        bwd_parts = time_ms(lambda: pm.mlp_bwd_kernel(x, w1, b1, w2, do),
                            by_kernel=True)
        fwd_parts = {k: time_ms(lambda: pm.mlp_fwd_kernel(x, w1, b1, w2, b2,
                                                          hp), by_kernel=True)
                     for k, hp in (("fwd", False), ("fwd_hpre", True))}
        fwd_split = {k: fwd_pass_ms(v) for k, v in fwd_parts.items()}
        ms = dict(
            fwd=sum(fwd_parts["fwd"].values()),
            fwd_hpre=sum(fwd_parts["fwd_hpre"].values()),
            bwd=sum(bwd_parts.values()),
            bwd_dx=time_ms(lambda: pm.mlp_bwd_dx_kernel(x, w1, b1, w2, do)),
            dw=time_ms(lambda: pm.weight_grads_kernel(x, gh))
            + time_ms(lambda: pm.weight_grads_kernel(act, do)))
        # K7's gh pass (with the db1 fold), dx pass and K9 apart
        split = {k: sum(v for n, v in bwd_parts.items() if any(
            s in n for s in keys)) for k, keys in (
                ("gh", ("mlp_gh", "colsum_fold")),
                ("dx", ("mlp_dx", "mlp_epilogue")), ("k9", ("mlp_dw",)))}
        plain = dict(
            fwd=time_ms(lambda: pm.mlp_fwd_reference(f["x"], f["w1"], b1,
                                                     f["w2"], b2)),
            fwd_hpre=time_ms(lambda: pm.mlp_fwd_reference(
                f["x"], f["w1"], b1, f["w2"], b2, save_hpre=True)),
            bwd=time_ms(lambda: pm.mlp_bwd_reference(f["x"], f["w1"], b1,
                                                     f["w2"], f["do"])),
            bwd_dx=time_ms(lambda: pm.mlp_bwd_dx_reference(
                f["x"], f["w1"], b1, f["w2"], f["do"])),
            dw=time_ms(lambda: pm.weight_grads_reference(f["x"], gh.float()))
            + time_ms(lambda: pm.weight_grads_reference(act.float(),
                                                        f["do"])))
        fwd_c = time_ms(lambda: dense_mlp_fwd(x, w1, b1, w2, b2))
        composite = dict(
            fwd=fwd_c, fwd_hpre=fwd_c,
            bwd=time_ms(lambda: dense_mlp_bwd(x, w1, b1, w2, do, True)),
            bwd_dx=time_ms(lambda: dense_mlp_bwd(x, w1, b1, w2, do, False)))
        # the f32-output product is K9's function without db; the bf16-output
        # one, the earlier yardstick, is logged beside it
        library = dict(dw=time_ms(lambda: torch.mm(gh.t(), x,
                                                   out_dtype=torch.float32))
                       + time_ms(lambda: torch.mm(do.t(), act,
                                                  out_dtype=torch.float32)))
        mm_bf16 = (time_ms(lambda: torch.mm(gh.t(), x))
                   + time_ms(lambda: torch.mm(do.t(), act)))
        bb, fb = 2, 4  # bytes of a bf16 and an f32 value
        bounds = dict(
            fwd=bound_ms(4 * t * d * h,
                         bb * (2 * t * d + 2 * d * h) + fb * (h + d)),
            fwd_hpre=bound_ms(4 * t * d * h,
                              bb * (2 * t * d + 2 * d * h + t * h)
                              + fb * (h + d)),
            bwd=bound_ms(10 * t * d * h,
                         bb * (3 * t * d + 2 * d * h)
                         + fb * (h + 2 * d * h + h + d)),
            bwd_dx=bound_ms(6 * t * d * h,
                            bb * (3 * t * d + 2 * d * h + 2 * t * h) + fb * h),
            dw=bound_ms(4 * t * d * h + t * (h + d),
                        bb * 2 * (t * d + t * h) + fb * (2 * d * h + h + d)))
        cb, cc, ce = (c.get((t, d, h), {}) for c in (calls_b, calls_c,
                                                       calls_e))
        calls = dict(fwd=cb.get("mlp_fwd", 0), fwd_hpre=cc.get("mlp_fwd", 0),
                     bwd=cb.get("mlp_bwd", 0), bwd_dx=cc.get("mlp_bwd_dx", 0),
                     dw=cc.get("mlp_dw", 0) // 2)
        row_e = dict(fwd=ce.get("mlp_fwd", 0), bwd=ce.get("mlp_bwd", 0))
        rows.append(dict(T=t, D=d, H=h, calls=calls, calls_e=row_e,
                         errs=errs, ms=ms, bwd_split_ms=split,
                         fwd_split_ms=fwd_split,
                         plain_ms=plain, composite_ms=composite,
                         library_ms=library, mm_bf16_ms=mm_bf16,
                         bound=bounds))
        log(f"  mlp T={t:5d} D={d} H={h} calls/step B {calls['fwd']} "
            f"C {calls['bwd_dx']}+{calls['fwd_hpre']} E {row_e['bwd']}  "
            f"worst rel err {errs[worst][1]:.1e} ({worst}) <= {MLP_TOL}")
        for k in ms:
            extra_s = (f" mm f32 {library[k]:.4f} (bf16 out {mm_bf16:.4f})"
                       if k in library else
                       f" composite {composite[k]:.4f} "
                       f"({ms[k] / composite[k]:.2f}x)")
            if k == "bwd":
                extra_s += (f" [gh {split['gh']:.4f} dx {split['dx']:.4f} "
                            f"K9 {split['k9']:.4f}]")
            if k in fwd_split:
                extra_s += f" [{fmt_passes(fwd_split[k])}]"
            log(f"    {k:8s} {ms[k]:.4f} ms plain {plain[k]:.4f}{extra_s} "
                f"bound {bounds[k][0]:.4f} ({100 * bounds[k][0] / ms[k]:.1f}%)")
    for label, key, field in (("B", "bwd", "calls"), ("C", "bwd_dx", "calls"),
                              ("E", "bwd", "calls_e"), ("B", "fwd", "calls"),
                              ("C", "fwd_hpre", "calls"),
                              ("E", "fwd", "calls_e")):
        tot = {n: sum(r[n][key] * r[field][key] for r in rows)
               for n in ("ms", "composite_ms", "plain_ms")}
        bnd = sum(r["bound"][key][0] * r[field][key] for r in rows)
        passes = ""
        if key in ("fwd", "fwd_hpre"):
            passes = " [" + fmt_passes({k: sum(
                r["fwd_split_ms"][key][k] * r[field][key] for r in rows)
                for k, _ in FWD_PASSES}) + "]"
        log(f"  mlp {key} per phase-{label} step: {tot['ms']:.3f} ms{passes}, "
            f"composite {tot['composite_ms']:.3f}, plain {tot['plain_ms']:.3f},"
            f" bound {bnd:.3f}")
    return rows


def check_ln_bwd(shapes, gen, eps: float = 1e-5):
    """K10 at each (rows, C) of ``shapes`` ({(rows, C): calls per step})
    against its plain version in float32 on the same bf16 values; times of
    kernel (and of its rows and cols kernels), plain version and torch's
    LayerNorm backward
    (``native_layer_norm_backward``, given the flax-formula mean and rstd:
    the same function)."""
    from avsiam_tpu_torch.ops.layernorm import (_stats_f32, ln_bwd_kernel,
                                                ln_bwd_reference)
    native = torch.ops.aten.native_layer_norm_backward
    rows = []
    for (r, c), calls in shapes.items():
        x = torch.randn((r, c), generator=gen, device="cuda").bfloat16()
        dy = torch.randn((r, c), generator=gen, device="cuda").bfloat16()
        scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        got = ln_bwd_kernel(x, dy, scale, eps)
        torch.cuda.synchronize()
        want = ln_bwd_reference(x.float(), dy.float(), scale, eps)
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        err = max(errs, key=lambda e: e[1])
        if err[1] > LN_TOL:
            raise AssertionError(f"ln_bwd R={r} C={c}: rel errs "
                                 f"{[e[1] for e in errs]} > {LN_TOL}")
        # torch takes no float32 weight beside bf16 x on the card, so it is
        # timed with the weight in bf16 (the bias only asks for dbeta); the
        # statistics go in the dtype and shape its forward gives them
        w16 = scale.bfloat16()
        b16 = torch.zeros_like(w16)
        _, mu0, rstd0 = torch.native_layer_norm(x, [c], w16, b16, eps)
        mu, rstd = (t.to(m.dtype).view_as(m) for t, m in
                    zip(_stats_f32(x.float(), eps), (mu0, rstd0)))
        lib = time_ms(lambda: native(dy, x, [c], mu, rstd, w16, b16,
                                     [True, True, True]))
        parts = time_ms(lambda: ln_bwd_kernel(x, dy, scale, eps),
                        by_kernel=True)
        ms = sum(parts.values())
        split = {k: sum(t for n, t in parts.items() if f"ln_bwd_{k}" in n)
                 for k in ("rows", "cols")}
        plain = time_ms(lambda: ln_bwd_reference(x.float(), dy.float(),
                                                 scale, eps))
        # bytes: x, dy read and dx written (bf16), scale read and dgamma,
        # dbeta written (f32); about 15 float32 operations a value
        bd = bound_ms(15 * r * c, 3 * r * c * 2 + 3 * c * 4, PEAK_F32_FLOPS)
        rows.append(dict(R=r, C=c, calls=calls, err=dict(ln=err),
                         ms=dict(ln=ms), split_ms=split,
                         plain_ms=dict(ln=plain),
                         library_ms=dict(ln=lib), bound=dict(ln=bd)))
        log(f"  ln_bwd R={r:5d} C={c} x{calls:3d}/step  err {err[0]:.2e} "
            f"(rel {err[1]:.1e} <= {LN_TOL})  {ms:.4f} ms (rows "
            f"{split['rows']:.4f}, cols {split['cols']:.4f}) plain "
            f"{plain:.4f} native {lib:.4f} ({ms / lib:.2f}x) bound {bd[0]:.4f} "
            f"({100 * bd[0] / ms:.1f}%)")
    return rows


def check_attention_hm(shapes, extra, gen):
    """K5 and K6 at each (b, N, H, D) of ``shapes`` ({shape: calls per
    step}) and of ``extra`` ([(shape, masked)]), reading q, k, v as the
    three slices of a packed bf16 qkv, against their plain versions in
    float32 on the same values (K6 against both plain forms: the JAX form
    that recomputes the softmax and the saved-statistics form, fed K5's
    output and statistics); where K1 takes the shape, K5 against K1 too.
    Times of kernel (K6: the whole call, delta included), plain version (K6:
    the saved-statistics form) and SDPA on contiguous bf16 [B, H, N, D]
    copies."""
    import torch.nn.functional as F
    from avsiam_tpu_torch.ops import attention as pat
    rows = []
    for (b, n, heads, hd), calls, masked in (
            [(k, c, False) for k, c in shapes.items()]
            + [(k, 0, m) for k, m in extra]):
        C = heads * hd
        xqkv = torch.randn((b, n, 3 * C), generator=gen, device="cuda"
                           ).bfloat16()
        q, k, v = xqkv.view(b, n, 3, heads, hd).unbind(2)
        dout = torch.randn((b, n, heads, hd), generator=gen, device="cuda"
                           ).bfloat16()
        kv = random_key_mask(b, n, gen) if masked else None
        out, stats = pat.attention_hm_fwd_kernel(q, k, v, kv)
        grads = pat.attention_hm_bwd_kernel(q, k, v, out, stats, dout, kv)
        torch.cuda.synchronize()
        f = [t.float() for t in (q, k, v)]
        ferr = rel_err(out, pat.attention_hm_reference(*f, kv))
        # the max and the 1/denominator each against its own scale: the max
        # is far larger, and one scale for both would hide a wrong 1/denom
        want_st = pat.attention_hm_stats_reference(f[0], f[1], kv)
        serr = max((rel_err(stats[..., i], want_st[..., i]) for i in (0, 1)),
                   key=lambda e: e[1])
        berr = max((rel_err(g, w) for form in (
            pat.attention_hm_bwd_reference(*f, dout.float(), kv),
            pat.attention_hm_bwd_stats_reference(*f, out.float(), stats,
                                                 dout.float(), kv))
            for g, w in zip(grads, form)), key=lambda e: e[1])
        k1 = None
        if pat.attention_route("pallas", C, heads) == "token_major":
            k1 = rel_err(out, pat.attention_fwd_kernel(xqkv, heads, kv)[0]
                         .view(b, n, heads, hd))[1]
        if max(ferr[1], serr[1], berr[1], k1 or 0.0) > ATTN_TOL:
            raise AssertionError(
                f"attention_hm b={b} N={n} H={heads} D={hd} masked={masked}: "
                f"fwd rel err {ferr[1]:.3e}, stats {serr[1]:.3e}, bwd "
                f"{berr[1]:.3e}, against K1 {k1} > {ATTN_TOL}")
        ms = dict(fwd=time_ms(lambda: pat.attention_hm_fwd_kernel(q, k, v,
                                                                  kv)),
                  bwd=time_ms(lambda: pat.attention_hm_bwd_kernel(
                      q, k, v, out, stats, dout, kv)))
        of, df = out.float(), dout.float()
        plain = dict(
            fwd=time_ms(lambda: pat.attention_hm_reference(*f, kv)),
            bwd=time_ms(lambda: pat.attention_hm_bwd_stats_reference(
                *f, of, stats, df, kv)))
        qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        mask = None if kv is None else kv[:, None, None, :]
        lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        do_h = dout.transpose(1, 2).contiguous()
        library = dict(
            fwd=time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask)),
            bwd=time_ms(lambda: torch.autograd.grad(
                lib_out, (qh, kh, vh), do_h, retain_graph=True)))
        # the functions the JAX kernels compute, not what this design moves
        # besides (K5's statistics, K6 reading them and o): operations q k^T
        # and p v forward; the backward recomputes q k^T and adds do v^T,
        # dv, dq and dk. Bytes (bf16): q, k, v read and o written; q, k, v,
        # do read and dq, dk, dv written.
        sq = b * heads * n * n * hd
        tok = b * n * C * 2  # one [B, N, H, D] bf16 tensor
        bounds = dict(fwd=bound_ms(4 * sq, 4 * tok),
                      bwd=bound_ms(10 * sq, 7 * tok))
        rows.append(dict(b=b, N=n, H=heads, D=hd, masked=masked, calls=calls,
                         err=dict(fwd=ferr, bwd=berr), stats_err=serr,
                         k1_rel=k1, ms=ms, plain_ms=plain, library_ms=library, bound=bounds))
        log(f"  attention_hm b={b} N={n:4d} H={heads:2d} D={hd} "
            f"mask={int(masked)} x{calls:3d}/step  fwd err {ferr[0]:.2e} "
            f"(rel {ferr[1]:.1e} <= {ATTN_TOL}; stats {serr[1]:.1e}"
            + ("" if k1 is None else f"; vs K1 {k1:.1e}")
            + f") {ms['fwd']:.4f} ms plain {plain['fwd']:.4f} sdpa "
            f"{library['fwd']:.4f} ({ms['fwd'] / library['fwd']:.2f}x) bound "
            f"{bounds['fwd'][0]:.4f} ({100 * bounds['fwd'][0] / ms['fwd']:.1f}"
            f"%) | bwd err "
            f"{berr[0]:.2e} (rel {berr[1]:.1e}) {ms['bwd']:.4f} ms plain "
            f"{plain['bwd']:.4f} sdpa {library['bwd']:.4f} bound "
            f"{bounds['bwd'][0]:.4f}")
    return rows


# head widths no step phase runs: (b, N, H, D), K1/K2 at D | 128 with C a
# multiple of 128, K5/K6 up to 128 (K1/K2 also take the first and last)
WIDTHS_TM = ((2, 512, 16, 8), (2, 512, 8, 16), (2, 512, 2, 128))
WIDTHS_HM = ((2, 512, 16, 8), (2, 512, 8, 16), (2, 512, 4, 48),
             (2, 512, 2, 128))


def check_widths(gen):
    """K1/K2 at ``WIDTHS_TM`` and K5/K6 at ``WIDTHS_HM``, each with and
    without masked keys, against their plain versions in float32 on the
    same bf16 values (K6 against the saved-statistics form, fed K5's output
    and statistics); the kernels' device time per call."""
    from avsiam_tpu_torch.ops import attention as pat
    rows = []
    for route, shapes in (("token_major", WIDTHS_TM),
                          ("head_major", WIDTHS_HM)):
        for (b, n, heads, hd), masked in (
                (s_, m) for s_ in shapes for m in (False, True)):
            C = heads * hd
            xqkv = torch.randn((b, n, 3 * C), generator=gen, device="cuda"
                               ).bfloat16()
            dout = torch.randn((b, n, C), generator=gen, device="cuda"
                               ).bfloat16()
            kv = random_key_mask(b, n, gen) if masked else None
            q, k, v = xqkv.view(b, n, 3, heads, hd).unbind(2)
            f = [t.float() for t in (q, k, v)]
            do = dout.view(b, n, heads, hd)
            if route == "token_major":
                def fwd():
                    return pat.attention_fwd_kernel(xqkv, heads, kv)
                out_c, stats = fwd()

                def bwd():
                    return pat.attention_bwd_kernel(xqkv, out_c, stats, dout,
                                                    heads, kv)
                grads = bwd().view(b, n, 3, heads, hd).unbind(2)
                out = out_c.view(b, n, heads, hd)
            else:
                def fwd():
                    return pat.attention_hm_fwd_kernel(q, k, v, kv)
                out, stats = fwd()

                def bwd():
                    return pat.attention_hm_bwd_kernel(q, k, v, out, stats,
                                                       do, kv)
                grads = bwd()
            torch.cuda.synchronize()
            ferr = rel_err(out, pat.attention_hm_reference(*f, kv))
            berr = max((rel_err(g, w) for g, w in zip(
                grads, pat.attention_hm_bwd_stats_reference(
                    *f, out.float(), stats, do.float(), kv))),
                key=lambda e: e[1])
            if max(ferr[1], berr[1]) > ATTN_TOL:
                raise AssertionError(
                    f"{route} attention b={b} N={n} H={heads} D={hd} "
                    f"masked={masked}: fwd rel err {ferr[1]:.3e}, bwd "
                    f"{berr[1]:.3e} > {ATTN_TOL}")
            ms = dict(fwd=time_ms(fwd, iters=10), bwd=time_ms(bwd, iters=10))
            rows.append(dict(route=route, b=b, N=n, H=heads, D=hd,
                             masked=masked, fwd_err=ferr, bwd_err=berr,
                             ms=ms))
            log(f"  {'K1/K2' if route == 'token_major' else 'K5/K6'} b={b} "
                f"N={n} H={heads:2d} D={hd:3d} mask={int(masked)}  fwd rel "
                f"err {ferr[1]:.1e}, bwd {berr[1]:.1e} <= {ATTN_TOL}  "
                f"{ms['fwd']:.4f} + {ms['bwd']:.4f} ms a call")
    return rows


GELU_FORMS = ("ans", "tanh", "cheb", "tanh5")  # 'erf' runs as 'ans'


def check_gelu_forms(shape, gen, eps: float = 1e-5):
    """K3, K4 (saving the hidden), K7 and K8 under each GELU form the
    kernels run, at one (rows, D, H[, impl]) of a ViT-B step, against their
    plain versions in float32 on the same values; each kernel's device time
    per call under each form; then, in float32 storage, the form itself
    (``check_gelu_form``)."""
    from avsiam_tpu_torch.ops import mlp as pm
    t, d, h = shape[:3]
    o = mlp_operands(gen, t, d, h)
    x, w1, b1, w2, b2, do = (o[k] for k in ("x", "w1", "b1", "w2", "b2",
                                            "do"))
    f = {k: v.float() for k, v in o.items()}
    g = 1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
    bl = 0.1 * torch.randn((d,), generator=gen, device="cuda")
    rows = []
    for form in GELU_FORMS:
        calls = {
            "ln_mlp_fwd": (
                lambda: pm.ln_mlp_fwd_kernel(x, g, bl, w1, b1, w2, b2, eps,
                                             gelu=form),
                lambda: pm.ln_mlp_reference(f["x"], g, bl, f["w1"], b1,
                                            f["w2"], b2, eps, gelu=form)),
            "mlp_fwd": (
                lambda: pm.mlp_fwd_kernel(x, w1, b1, w2, b2, True,
                                          gelu=form),
                lambda: pm.mlp_fwd_reference(f["x"], f["w1"], b1, f["w2"],
                                             b2, form, True)),
            "mlp_bwd": (
                lambda: pm.mlp_bwd_kernel(x, w1, b1, w2, do, gelu=form),
                lambda: pm.mlp_bwd_reference(f["x"], f["w1"], b1, f["w2"],
                                             f["do"], form)),
            "mlp_bwd_dx": (
                lambda: pm.mlp_bwd_dx_kernel(x, w1, b1, w2, do, gelu=form),
                lambda: pm.mlp_bwd_dx_reference(f["x"], f["w1"], b1,
                                                f["w2"], f["do"], form)),
        }
        for name, (kernel, plain) in calls.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(got, want, strict=True)]
            rel = max(e[1] for e in errs)
            if rel > MLP_TOL:
                raise AssertionError(f"{name} gelu={form} T={t} D={d} H={h}: "
                                     f"rel err {rel:.3e} > {MLP_TOL}")
            ms = time_ms(kernel, iters=10)
            rows.append(dict(kernel=name, gelu=form, T=t, D=d, H=h,
                             max_abs_err=max(e[0] for e in errs),
                             max_rel_err=rel, ms=ms))
        rows[-1]["form_check"] = check_gelu_form(form, o)
    base = {r["kernel"]: r["ms"] for r in rows if r["gelu"] == "ans"}
    for r in rows:
        log(f"  gelu {r['gelu']:5s} {r['kernel']:10s} T={t} D={d} H={h}  "
            f"rel err {r['max_rel_err']:.1e} <= {MLP_TOL}  {r['ms']:.4f} "
            f"ms/call ('ans' {base[r['kernel']]:.4f}, "
            f"{r['ms'] / base[r['kernel']]:.3f}x)")
    return rows


GELU_FORM_ATOL = 1e-4
# Pairs of forms whose float32 values differ by float32 rounding only
# ('cheb' and 'ans' by about 1e-7 RMS in act and gelu'): not told apart.
GELU_TWINS = ({"ans", "cheb"},)


def check_gelu_form(form, o):
    """The form the kernels run, where the bf16 checks cannot show it: K8's
    float32 act and gh against each form's plain act and (do w2) * gelu',
    in float64 from K4's float32 hpre (the same bf16 operands and f32
    accumulation as K8's recomputed hidden). Within ``GELU_FORM_ATOL`` of
    the asked form's, and at most half as far from it (RMS) as from any
    other form the values tell apart. Returns the errors and ratios."""
    from avsiam_tpu_torch.ops import gelu as pg
    from avsiam_tpu_torch.ops import mlp as pm
    x, do = o["x"].float(), o["do"].float()
    _, hpre = pm.mlp_fwd_kernel(x, o["w1"], o["b1"], o["w2"], o["b2"], True,
                                gelu=form)
    _, gh, act = pm.mlp_bwd_dx_kernel(x, o["w1"], o["b1"], o["w2"], do,
                                      gelu=form)
    h64 = hpre.double()
    dw = o["do"].double() @ o["w2"].double()

    def plain(f):
        return pg.gelu_f32(h64, f), dw * pg.gelu_grad_f32(h64, f)

    def rms(a, b):
        return float((a.double() - b).pow(2).mean().sqrt())

    mine = plain(form)
    err = [float((a.double() - b).abs().max())
           for a, b in zip((act, gh), mine, strict=True)]
    ratios = {}
    for other in GELU_FORMS:
        if other == form or {form, other} in GELU_TWINS:
            continue
        ratios[other] = max(
            rms(a, b) / rms(a, c)
            for a, b, c in zip((act, gh), mine, plain(other), strict=True))
    log(f"  gelu {form:5s} form check (K4's f32 hpre, K8's f32 act and gh): "
        f"max err {err[0]:.1e}, {err[1]:.1e} <= {GELU_FORM_ATOL}; RMS to "
        f"'{form}' / RMS to the other form: " + ", ".join(
            f"{k} {v:.3f}" for k, v in ratios.items()) + " <= 0.5")
    if max(err) > GELU_FORM_ATOL or any(v > 0.5 for v in ratios.values()):
        raise AssertionError(f"gelu={form}: the kernels do not run the "
                             f"asked form (max err {err}, ratios {ratios})")
    return dict(max_err_act=err[0], max_err_gh=err[1], rms_ratio=ratios)


def golden_waveforms() -> dict:
    """The waveforms of the committed fbank golden, by the recipe of
    ``scripts/gen_goldens.py:golden_waveforms`` (copied here, so that this
    script imports nothing of the repo outside the port)."""
    import numpy as np
    sr = 16000
    rs = np.random.RandomState(0)
    t1 = np.arange(sr) / sr
    return {
        "noise_1s": (rs.randn(sr) * 0.1).astype(np.float32),
        "tone_440": (0.5 * np.sin(2 * np.pi * 440.0 * np.arange(sr // 2)
                                  / sr)).astype(np.float32),
        "chirp": (0.3 * np.sin(2 * np.pi * (100.0 + (7900.0 - 100.0)
                                            * t1 / 2.0) * t1)
                  ).astype(np.float32),
        "impulse": np.concatenate(
            [np.zeros(1000, np.float32), np.asarray([0.9], np.float32),
             np.zeros(sr * 3 // 10 - 1001, np.float32)]),
        "noise_2s": (rs.randn(2 * sr) * 0.05).astype(np.float32),
    }


FBANK_ATOL, FBANK_RTOL = 5e-3, 5e-4  # tests/test_fbank.py's limits
TRANSFORM_ATOL = 5e-3


def check_fbank():
    """``kaldi_fbank`` on the card against ``tests/fixtures/
    fbank_golden.npz`` (the native C++ oracle's), over the golden
    waveforms, within atol 5e-3 and rtol 5e-4."""
    import numpy as np
    from avsiam_tpu_torch.ops.fbank import kaldi_fbank
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures", "fbank_golden.npz")
    golden = dict(np.load(path))
    worst = 0.0
    for name, wav in golden_waveforms().items():
        got = kaldi_fbank(torch.from_numpy(wav).cuda()).cpu().numpy()
        want = golden[name]
        if got.shape != want.shape:
            raise AssertionError(f"fbank {name}: shape {got.shape} != "
                                 f"{want.shape}")
        excess = np.abs(got - want) - (FBANK_ATOL + FBANK_RTOL * np.abs(want))
        worst = max(worst, float(np.abs(got - want).max()))
        if not np.isfinite(got).all() or (excess > 0).any():
            raise AssertionError(f"fbank {name} on the card: max err "
                                 f"{np.abs(got - want).max():.3e} beyond atol "
                                 f"{FBANK_ATOL}, rtol {FBANK_RTOL}")
    log(f"  fbank on the card against the native golden: {len(golden)} "
        f"waveforms, max abs err {worst:.2e} (atol {FBANK_ATOL}, rtol "
        f"{FBANK_RTOL})")
    return dict(max_abs_err=worst, waveforms=len(golden))


def check_transform(gen, seed: int, batch: int = 8):
    """The train transform under the finetune recipes' augmentations
    (freqm 48, timem 192, mixup 0.5, noise; ``recipes/ft_*.sh``) at B=8,
    on the card against the port's plain transform on the CPU from the
    same draws: the SpecAugment masks and the time rolls equal, every value
    within atol 5e-3."""
    from avsiam_tpu_torch.configs import AudioConfig
    from avsiam_tpu_torch.data.dataset import make_train_transform
    from avsiam_tpu_torch.ops import augment as aug
    cfg = AudioConfig(freqm=48, timem=192, mixup=0.5, noise=True)
    n = int(cfg.sample_rate * (cfg.target_length + 2) * cfg.frame_shift_ms
            / 1000.0)
    B = batch
    wav = torch.randn((B, n), generator=gen, device="cuda") * 0.05
    wav = wav - wav.mean(dim=-1, keepdim=True)
    frames = torch.randint(0, 255, (B, 1, 224, 224, 3), generator=gen,
                           device="cuda", dtype=torch.uint8)
    labels = (torch.rand((B, 527), generator=gen, device="cuda")
              < 0.01).float()
    wav_len = torch.full((B,), n, dtype=torch.int32, device="cuda")
    wav_len[::2] = n // 2  # half the clips end halfway: rows zeroed
    draws = aug.draw_transform(
        cfg, B, torch.Generator(device="cuda").manual_seed(seed))
    cpu_draws = aug.TransformDraws(*(d.cpu() for d in draws))
    tr = make_train_transform(cfg, im_res=224)
    got = tr(draws, wav, frames, labels, wav_len)
    want = tr(cpu_draws, wav.cpu(), frames.cpu(), labels.cpu(),
              wav_len.cpu())
    T, F = cfg.target_length, cfg.num_mel_bins
    ones = torch.ones((B, T, F), device="cuda")
    masks = aug.spec_augment(ones, cfg.freqm, cfg.timem, draws.freq_u,
                             draws.time_u) == 0
    cpu_masks = aug.spec_augment(ones.cpu(), cfg.freqm, cfg.timem,
                                 cpu_draws.freq_u, cpu_draws.time_u) == 0
    rows = torch.arange(T, dtype=torch.float32, device="cuda")
    rows = rows[None, :, None].expand(B, T, F).contiguous()
    rolled = aug.noise_and_roll(rows, torch.zeros_like(rows), draws.noise_u,
                                draws.shift)
    cpu_rolled = aug.noise_and_roll(rows.cpu(), torch.zeros_like(rows.cpu()),
                                    cpu_draws.noise_u, cpu_draws.shift)
    if not torch.equal(masks.cpu(), cpu_masks) or not cpu_masks.any():
        raise AssertionError("transform: the SpecAugment masks on the card "
                             "differ from the CPU's")
    if not torch.equal(rolled.cpu(), cpu_rolled):
        raise AssertionError("transform: the time rolls on the card differ "
                             "from the CPU's")
    errs = {}
    for name, g, w in zip(("fbank", "image", "labels"), got, want,
                          strict=True):
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"transform {name}: {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)}, or not finite")
        errs[name] = float((g.cpu() - w).abs().max())
    log(f"  train transform (freqm 48, timem 192, mixup 0.5, noise) at B={B}:"
        f" masks and rolls equal, max abs err "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (atol {TRANSFORM_ATOL})")
    if max(errs.values()) > TRANSFORM_ATOL:
        raise AssertionError(f"transform on the card vs the CPU: {errs} > "
                             f"{TRANSFORM_ATOL}")
    return errs


def check_float32(gen, eps: float = 1e-5):
    """The kernels' float32-storage variants (off the bf16 step paths) at one
    encoder and one decoder shape each, against the plain version."""
    from avsiam_tpu_torch.ops.attention import (attention_bwd_kernel,
                                                attention_fwd_kernel,
                                                attention_reference)
    from avsiam_tpu_torch.ops.mlp import ln_mlp_fwd_kernel, ln_mlp_reference
    errs = {}
    for b, n, heads, hd in ((2, 177, 12, 64), (2, 708, 16, 32)):
        x = torch.randn((b, n, 3 * heads * hd), generator=gen, device="cuda")
        do = torch.randn((b, n, heads * hd), generator=gen, device="cuda")
        out, stats = attention_fwd_kernel(x, heads)
        dx = attention_bwd_kernel(x, out, stats, do, heads)
        xr = x.clone().requires_grad_(True)
        ref = attention_reference(xr, heads)
        (gref,) = torch.autograd.grad(ref, xr, do)
        errs[f"attention N={n} D={hd}"] = (rel_err(out, ref)[1],
                                           rel_err(dx, gref)[1])
    for t, d in ((392, 768), (708, 512)):
        h = 4 * d
        x = torch.randn((t, d), generator=gen, device="cuda")
        w1 = (torch.randn((h, d), generator=gen, device="cuda") * d ** -0.5
              ).bfloat16()
        w2 = (torch.randn((d, h), generator=gen, device="cuda") * h ** -0.5
              ).bfloat16()
        g = torch.ones(d, device="cuda")
        z, zh = torch.zeros(d, device="cuda"), torch.zeros(h, device="cuda")
        out, hpre = ln_mlp_fwd_kernel(x, g, z, w1, zh, w2, z, eps)
        ref, href = ln_mlp_reference(x, g, z, w1.float(), zh, w2.float(), z,
                                     eps)
        errs[f"ln_mlp T={t} D={d}"] = (rel_err(out, ref)[1],
                                       rel_err(hpre, href)[1])
    from avsiam_tpu_torch.ops import mlp as pm
    for t, d in ((392, 768), (708, 512), (156, 1280)):
        o = mlp_operands(gen, t, d, 4 * d)
        x, do = o["x"].float(), o["do"].float()
        w1, b1, w2, b2 = o["w1"], o["b1"], o["w2"], o["b2"]
        w1f, w2f = w1.float(), w2.float()
        out, hpre = pm.mlp_fwd_kernel(x, w1, b1, w2, b2, True)
        ref, href = pm.mlp_fwd_reference(x, w1f, b1, w2f, b2, save_hpre=True)
        errs[f"mlp_fwd T={t} D={d}"] = (rel_err(out, ref)[1],
                                        rel_err(hpre, href)[1])
        got = pm.mlp_bwd_kernel(x, w1, b1, w2, do)
        want = pm.mlp_bwd_reference(x, w1f, b1, w2f, do)
        errs[f"mlp_bwd T={t} D={d}"] = (rel_err(got[0], want[0])[1], max(
            rel_err(g, w)[1] for g, w in zip(got[1:], want[1:])))
        dx, gh, act = pm.mlp_bwd_dx_kernel(x, w1, b1, w2, do)
        want = pm.mlp_bwd_dx_reference(x, w1f, b1, w2f, do)
        errs[f"mlp_bwd_dx T={t} D={d}"] = (rel_err(dx, want[0])[1], max(
            rel_err(gh, want[1])[1], rel_err(act, want[2])[1]))
        dw, db = pm.weight_grads_kernel(act, do)
        wdw, wdb = pm.weight_grads_reference(act, do)
        errs[f"mlp_dw T={t} D={d}"] = (rel_err(dw, wdw)[1],
                                       rel_err(db, wdb)[1])
    from avsiam_tpu_torch.ops import attention as pat
    b, n, heads, hd = 2, 177, 16, 80
    x = torch.randn((b, n, 3 * heads * hd), generator=gen, device="cuda")
    q, k, v = x.view(b, n, 3, heads, hd).unbind(2)
    do = torch.randn((b, n, heads, hd), generator=gen, device="cuda")
    out, stats = pat.attention_hm_fwd_kernel(q, k, v)
    grads = pat.attention_hm_bwd_kernel(q, k, v, out, stats, do)
    errs[f"attention_hm N={n} D={hd}"] = (
        rel_err(out, pat.attention_hm_reference(q, k, v))[1],
        max(rel_err(g, w)[1] for g, w in
            zip(grads, pat.attention_hm_bwd_reference(q, k, v, do))))
    from avsiam_tpu_torch.ops.layernorm import ln_bwd_kernel, ln_bwd_reference
    for r, c in ((1416, 1280), (5664, 512)):
        x = torch.randn((r, c), generator=gen, device="cuda")
        dy = torch.randn((r, c), generator=gen, device="cuda")
        scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        got = ln_bwd_kernel(x, dy, scale, eps)
        want = ln_bwd_reference(x, dy, scale, eps)
        errs[f"ln_bwd R={r} C={c}"] = (rel_err(got[0], want[0])[1], max(
            rel_err(g, w)[1] for g, w in zip(got[1:], want[1:])))
    for name, (e1, e2) in errs.items():
        log(f"  float32 {name}: rel err {e1:.1e} / {e2:.1e} (<= {ATTN_TOL})")
        if max(e1, e2) > ATTN_TOL:
            raise AssertionError(f"float32 {name}: rel err {e1}, {e2}")
    return errs


def bound_by(rows, key_bound):
    ops = sum(r[key_bound][1] * r["calls"] for r in rows)
    nbytes = sum(r[key_bound][2] * r["calls"] for r in rows)
    return "operations" if ops >= nbytes else "bytes"


def family_entry(name, key, phase, rows, launches, errs, library):
    """One ``kernels`` entry of the MLP family: per-step sums over the
    shapes, each weighted by its calls per step in ``phase``."""
    def total(field):
        return sum(r[field][key] * r["calls"][key] for r in rows)

    def bound(i):
        return sum(r["bound"][key][i] * r["calls"][key] for r in rows)

    return dict(
        name=name, route="cuda", source="avsiam_tpu_torch/csrc/mlp.cu",
        replaces={"mlp_fwd": "avsiam_tpu/ops/mlp.py:190",
                  "mlp_bwd": "avsiam_tpu/ops/mlp.py:232",
                  "mlp_bwd_dx": "avsiam_tpu/ops/mlp.py:280",
                  "mlp_dw": "avsiam_tpu/ops/mlp.py:314"}[name],
        phase=phase, launches=launches[phase][name],
        max_abs_err=max(r["errs"][e][0] for r in rows for e in r["errs"]
                        if e.split("[")[0] in errs),
        ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=bound(0),
        bound_by="operations" if bound(1) >= bound(2) else "bytes",
        library_ms=total("library_ms") if library else None,
        composite_ms=None if library else total("composite_ms"), passed=True)


def row_entry(name, source, replaces, phase, rows, key, launches):
    """One ``kernels`` entry from rows holding ``err``, ``ms``,
    ``plain_ms``, ``library_ms`` and ``bound`` dicts under ``key``: per-step
    sums over the shapes, each weighted by its calls per step in
    ``phase``."""
    def total(field):
        return sum(r[field][key] * r["calls"] for r in rows)

    def bound(i):
        return sum(r["bound"][key][i] * r["calls"] for r in rows)

    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        phase=phase, launches=launches[phase][name],
        max_abs_err=max(r["err"][key][0] for r in rows), ms=total("ms"),
        plain_ms=total("plain_ms"), bound_ms=bound(0),
        bound_by="operations" if bound(1) >= bound(2) else "bytes",
        library_ms=total("library_ms"), passed=True)


def kernel_entries(attn_rows, mlp_rows, fam_rows, ln_rows, hm_rows,
                   launches):
    """The ``kernels`` line. ``passed`` is true for every entry: each check
    above raises on a failure, so a failed kernel never reaches the line.
    ``launches`` maps each step phase to its counts; an entry's times are
    per step of the phase it names. ``library_ms`` is one PyTorch call's
    time where one computes the same function; K3, K4, K7 and K8 have none,
    and carry ``composite_ms``, the 'dense' form's GEMMs and elementwise ops
    on the same operands (not one call)."""
    def total(rows, key):
        return sum(r[key] * r["calls"] for r in rows)

    fwd_bound = total([dict(r, b_=r["fwd_bound"][0]) for r in attn_rows], "b_")
    bwd_bound = total([dict(r, b_=r["bwd_bound"][0]) for r in attn_rows], "b_")
    mlp_bound = total([dict(r, b_=r["bound"][0]) for r in mlp_rows], "b_")
    return [
        dict(name="attention_fwd", route="cuda",
             source="avsiam_tpu_torch/csrc/attention.cu",
             replaces="avsiam_tpu/ops/attention.py:535", phase="A",
             launches=launches["A"]["attention_fwd"],
             max_abs_err=max(r["fwd_err"] for r in attn_rows),
             ms=total(attn_rows, "fwd_ms"), plain_ms=total(attn_rows, "plain_fwd_ms"),
             bound_ms=fwd_bound, bound_by=bound_by(attn_rows, "fwd_bound"),
             library_ms=total(attn_rows, "lib_fwd_ms"), passed=True),
        dict(name="attention_bwd", route="cuda",
             source="avsiam_tpu_torch/csrc/attention.cu",
             replaces="avsiam_tpu/ops/attention.py:573", phase="A",
             launches=launches["A"]["attention_bwd"],
             max_abs_err=max(r["bwd_err"] for r in attn_rows),
             ms=total(attn_rows, "bwd_ms"), plain_ms=total(attn_rows, "plain_bwd_ms"),
             bound_ms=bwd_bound, bound_by=bound_by(attn_rows, "bwd_bound"),
             library_ms=total(attn_rows, "lib_bwd_ms"), passed=True),
        dict(name="ln_mlp_fwd", route="cuda",
             source="avsiam_tpu_torch/csrc/ln_mlp.cu",
             replaces="avsiam_tpu/ops/mlp.py:429", phase="A",
             launches=launches["A"]["ln_mlp_fwd"],
             max_abs_err=max(r["out_err"] for r in mlp_rows),
             ms=total(mlp_rows, "ms"), plain_ms=total(mlp_rows, "plain_ms"),
             bound_ms=mlp_bound, bound_by=bound_by(mlp_rows, "bound"),
             library_ms=None, composite_ms=total(mlp_rows, "composite_ms"),
             passed=True),
        family_entry("mlp_fwd", "fwd", "B", fam_rows, launches,
                     ("fwd", "fwd_hpre"), library=False),
        family_entry("mlp_bwd", "bwd", "B", fam_rows, launches, ("bwd",),
                     library=False),
        family_entry("mlp_bwd_dx", "bwd_dx", "C", fam_rows, launches,
                     ("bwd_dx",), library=False),
        family_entry("mlp_dw", "dw", "C", fam_rows, launches, ("dw1", "dw2"),
                     library=True),
        row_entry("ln_bwd", "avsiam_tpu_torch/csrc/layernorm.cu",
                  "avsiam_tpu/ops/layernorm.py:130", "D", ln_rows, "ln",
                  launches),
        row_entry("attention_hm_fwd", "avsiam_tpu_torch/csrc/attention_hm.cu",
                  "avsiam_tpu/ops/attention.py:242", "E", hm_rows, "fwd",
                  launches),
        row_entry("attention_hm_bwd", "avsiam_tpu_torch/csrc/attention_hm.cu",
                  "avsiam_tpu/ops/attention.py:282", "E", hm_rows, "bwd",
                  launches),
    ]


# -------------------------------------------------------------------- main
# the step phases: (label, configuration, AVSIAM_MLP_BWD=split,
# AVSIAM_LN=pallas, eager steps and graphed replays, batch); ``model`` names
# a variant, else ViT-B
PHASES = (("A", dict(mlp_impl="lnfres"), False, False, 5, 8),
          ("B", dict(mlp_impl="fused"), False, False, 5, 8),
          ("C", dict(mlp_impl="fbwd", dec_mlp_impl="fres"), True, False, 5,
           8),
          ("D", dict(mlp_impl="lnfres"), False, True, 5, 8),
          ("E", dict(model="cav-mae-huge", attn_impl="pallas",
                     mlp_impl="fused"), False, False, 3, 8),
          ("A64", dict(mlp_impl="lnfres"), False, False, 3, 64),
          ("P64", dict(mmixed_impl="padded"), False, False, 3, 64),
          ("H64", dict(model="cav-mae-huge", attn_impl="pallas",
                       mlp_impl="fused", remat_blocks=True), False, False, 2,
           64),
          *((f"F-{form}", dict(mmixed_impl=form), False, False, 2, 8)
            for form in ("tconcat", "bucketed", "packed")))
# the phases the depth-1 reference phase runs (A64 and F's forms share A's
# configuration but for the batch and the contrastive form)
REFERENCE_PHASES = ("A", "B", "C", "D", "E", "P64", "H64")


def bench_config(depth: int = 12, dec_depth: int = 8, batch: int = 8,
                 **impls):
    """The JAX bench's configuration (``mlp_impl='lnfres'``,
    ``mmixed_impl='exact'``), cut to B=8 unless ``batch`` says otherwise;
    ``impls`` overrides the impls."""
    from avsiam_tpu_torch.configs import (CAVMAEConfig, DecoderConfig,
                                          PretrainConfig, ViTConfig)
    impls = dict(dict(mlp_impl="lnfres", mmixed_impl="exact"), **impls)
    model = CAVMAEConfig(vit=ViTConfig(depth=depth),
                         decoder=DecoderConfig(depth=dec_depth),
                         dtype=torch.bfloat16, attn_impl="auto", **impls)
    return PretrainConfig(model=model, batch_size=batch)


def phase_config(impls, depth=None, dec_depth=None, batch: int = 8):
    """A phase's configuration at ``batch``: ``bench_config`` with ``impls``, or
    with ``impls['model']`` that variant's ``pretrain_config`` (bf16,
    'exact' unless ``impls`` says otherwise) in the other impls;
    ``depth``/``dec_depth`` cut the depths."""
    from avsiam_tpu_torch.configs import PretrainConfig, replace
    from avsiam_tpu_torch.models.variants import pretrain_config
    impls = dict(impls)
    name = impls.pop("model", None)
    if name is None:
        m = bench_config(**impls).model
    else:
        m = pretrain_config(name, dtype=torch.bfloat16,
                            **dict(dict(mmixed_impl="exact"), **impls))
    if depth is not None:
        m = replace(m, vit=replace(m.vit, depth=depth),
                    decoder=replace(m.decoder, depth=dec_depth))
    return PretrainConfig(model=m, batch_size=batch)


@contextlib.contextmanager
def env_flags(split: bool, ln_pallas: bool):
    """``AVSIAM_MLP_BWD=split`` and ``AVSIAM_LN=pallas`` set (or unset) for
    the block, then restored."""
    flags = {"AVSIAM_MLP_BWD": "split" if split else None,
             "AVSIAM_LN": "pallas" if ln_pallas else None}
    old = {k: os.environ.pop(k, None) for k in flags}
    os.environ.update({k: v for k, v in flags.items() if v})
    try:
        yield
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", default=None,
                    help="write per-shape measurements here as JSON")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from avsiam_tpu_torch import kernels

    # matmuls of the float32 plain versions run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.time()
    kernels.library()
    log(f"kernels built and loaded in {time.time() - t0:.1f} s")
    build_log = kernels.BUILD_DIR / "build.log"
    resources = kernel_resources(build_log.read_text()
                                 if build_log.exists() else "")
    for r in resources:
        log(f"  {r['name']}: {r['registers']} registers, {r['spill_stores']} "
            f"B spill stores, {r['spill_loads']} B spill loads, {r['stack']} "
            f"B stack")

    phases = {}
    for label, impls, split, ln, n_steps, batch in PHASES:
        cfg = phase_config(impls, batch=batch)
        phases[label] = dict(impls=impls, cfg=cfg, split=split, ln=ln,
                             n_steps=n_steps,
                             shapes=main_path_shapes(cfg, cfg.batch_size))
    attn_shapes, mlp_shapes = phases["A"]["shapes"][:2]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    report = {"device": card, "kernel_resources": resources}
    log("phase kernels: each kernel against its plain version")
    # beyond the B=8 step's shapes: the B=64 step's shortest chunks, and
    # random key masks
    extra = [((2, 102, 12, 64), False), ((2, 39, 12, 64), False),
             ((2, 177, 12, 64), True), ((2, 708, 16, 32), True)]
    attn_rows = check_attention(attn_shapes, extra, gen)
    # K3 also at ViT-L's (D 1024, H 4096) and ViT-H's (1280, 5120) encoder
    # shapes, which no step phase runs under 'lnfres'; the MLP family at
    # ViT-L's beside phase E's ViT-H shapes
    wide = [(t, d, 4 * d) for d in (1024, 1280) for t in (156, 1024, 1416)]
    mlp_rows = check_ln_mlp({**mlp_shapes, **{
        (t, d, h, "lnfres"): 0 for t, d, h in wide}}, gen)
    fam_rows = check_mlp_family(
        {p: mlp_shape_launches(phases[p]["shapes"][1], phases[p]["split"])
         for p in "BCE"}, [k for k in wide if k[1] == 1024], gen)
    # K10 at phase D's LN shapes and at ViT-H's width (phase E's encoder
    # LN shapes, which run the torch-ops backward there)
    ln_shapes = dict(phases["D"]["shapes"][2])
    ln_shapes.update({k: 0 for k in phases["E"]["shapes"][2]
                      if k[1] == 1280})
    ln_rows = check_ln_bwd(ln_shapes, gen)
    e = phases["E"]
    hm_rows = check_attention_hm(
        head_major_shapes(e["cfg"], e["shapes"][0]),
        [((2, 177, 16, 80), True), ((2, 196, 12, 64), False),
         ((2, 177, 12, 64), True)], gen)
    # K1/K2 at phase P64's masked encoder shapes, under the keep masks
    # 'padded' draws, timed beside SDPA with the same mask
    p64 = phases["P64"]
    attn_p64 = check_attention(
        {k: c for k, c in p64["shapes"].attn.items()
         if k in p64["shapes"].masked}, [], gen,
        masks=padded_masks_at(p64["cfg"], gen))
    log_attention_totals("P64", attn_p64)
    # the GELU forms of K3, K4, K7 and K8 at phase A's largest encoder
    # rows; K1/K2 and K5/K6 at the head widths no step phase runs
    gelu_rows = check_gelu_forms(max(k for k in mlp_shapes if k[1] == 768),
                                 gen)
    log("phase widths: K1/K2 at D 8, 16, 128; K5/K6 at D 8, 16, 48, 128")
    width_rows = check_widths(gen)
    log("phase data: the fbank and the train transform on the card, PD64's "
        "data pieces timed")
    report.update(gelu_forms=gelu_rows, widths=width_rows,
                  fbank=check_fbank(),
                  transform=check_transform(gen, args.seed),
                  data_pieces=time_data_pieces(phases["P64"]["cfg"],
                                               args.seed))
    log(f"kernels and data checks done at {time.time() - t0:.0f} s")
    report.update(attention=attn_rows, ln_mlp=mlp_rows, mlp_family=fam_rows,
                  ln_bwd=ln_rows, attention_hm=hm_rows,
                  attention_p64=attn_p64, float32=check_float32(gen),
                  at_shapes={label: check_at_shapes(label, p["cfg"],
                                                    p["shapes"], gen)
                             for label, p in phases.items()
                             if label in ("A64", "P64", "H64")
                             or label.startswith("F-")})
    launches = {}
    for label, p in phases.items():
        with env_flags(p["split"], p["ln"]):
            launches[label] = run_steps(
                label, p["cfg"], expected_launches(
                    p["cfg"], p["shapes"], p["split"], p["ln"], 1),
                args.seed, report, p["n_steps"])
        if label in ("A", "P64"):
            report.setdefault("eager_vs_graphed", {})[label] = \
                compare_eager_graphed(p["cfg"], args.seed)
    log(f"step phases done at {time.time() - t0:.0f} s")
    p64 = phases["P64"]
    launches["PD64"] = run_data_fed(
        "PD64", p64["cfg"], expected_launches(p64["cfg"], p64["shapes"],
                                              False, False, 1),
        args.seed, report)
    report["forms_vs_exact"] = compare_forms(phases["A"]["cfg"], args.seed)
    for label in REFERENCE_PHASES:
        p = phases[label]
        with env_flags(p["split"], p["ln"]):
            run_reference(label, p["impls"], args.seed, report)

    log(f"reference phases done at {time.time() - t0:.0f} s")
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    spilled = [r["name"] for r in resources if r["spill_stores"]
               and any(k in r["name"] for k in NO_SPILL)]
    if spilled:
        raise AssertionError(f"kernels that must not spill do: {spilled}")
    print(json.dumps({"steps": {
        label: {k: r.get(k) for k in STEP_KEYS}
        for label, r in report["steps"].items()},
        "eager_vs_graphed_max_rel": {
            k: r["max_rel"] for k, r in report["eager_vs_graphed"].items()},
        "forms_vs_exact_max_rel": report["forms_vs_exact"]}))
    log(card)
    entries = kernel_entries(attn_rows, mlp_rows, fam_rows, ln_rows, hm_rows,
                             launches)
    for e in entries:  # the data-fed phase's counts beside the phase's
        e["pd64_launches"] = launches["PD64"][e["name"]]
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def step_batch(cfg, gen):
    """A random (fbank, frames) batch of ``cfg``'s size on the card."""
    v, B = cfg.model.vit, cfg.batch_size
    return (torch.randn((B, v.audio_length, v.mel_bins), generator=gen,
                        device="cuda"),
            torch.randn((B, 3, v.img_size, v.img_size), generator=gen,
                        device="cuda"))


def timed_steps(label, step, state, batch, gen, lr, n_steps, first=0):
    """``n_steps`` calls of ``step``, each timed on the host clock up to a
    ``torch.cuda.synchronize()``; every metric must be finite. Returns
    [metrics and ms per step]."""
    steps = []
    for i in range(first, first + n_steps):
        t = time.time()
        state, metrics = step(state, batch, gen, lr)
        metrics = {k: float(x) for k, x in metrics.items()}
        torch.cuda.synchronize()
        ms = (time.time() - t) * 1e3
        if not all(math.isfinite(x) for x in metrics.values()):
            raise AssertionError(f"{label} step {i}: non-finite metrics "
                                 f"{metrics}")
        steps.append(dict(metrics, ms=ms))
        log(f"  {label} step {i}: " + " ".join(
            f"{k} {x:.5f}" for k, x in metrics.items()) + f"  {ms:.1f} ms")
    return steps


def median_after_first(steps):
    return sorted(s["ms"] for s in steps[1:])[(len(steps) - 1) // 2]


def memory_gib():
    return (torch.cuda.max_memory_allocated() / 2**30,
            torch.cuda.max_memory_reserved() / 2**30)


def check_launches(what, launches, per_step, n_steps):
    expected = {k: n * n_steps for k, n in per_step.items()}
    log(f"  {what} launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"{what}: kernel launches {launches} != "
                             f"{expected}")


# the numbers of each step phase in the ``steps`` line
STEP_KEYS = ("batch", "eager_steady_ms", "graphed_steady_ms",
             "eager_busy_share", "graphed_busy_share", "eager_kernels",
             "graphed_kernels", "eager_adam_ms", "graphed_adam_ms",
             "eager_peak_gib", "eager_reserved_gib", "graphed_peak_gib",
             "graphed_reserved_gib", "capture_s", "clips_per_s",
             "loader_wait_ms", "host_batch_ms", "h2d_ms", "transform_ms")


def run_steps(label, cfg, per_step, seed, report, n_steps: int = 5):
    """Full-width two-pass steps, eager and then graphed. Eager:
    ``n_steps`` steps and one profiled step. Graphed, on the same state: the
    warm-up step, the capture (whose call replays once), ``n_steps`` timed
    replays and one profiled replay. The eager steps' kernel launches,
    counted from 0 just before them, must be ``per_step``
    (``expected_launches`` of one step) times their steps, and the
    capture's must be ``per_step``. The profiled replay must call each of
    the port's kernels as often as the profiled eager step. Every metric
    must be finite. Returns the eager run's launch counts."""
    from avsiam_tpu_torch import kernels
    from avsiam_tpu_torch.train.pretrain import (init_state,
                                                 make_graphed_pretrain_step,
                                                 make_pretrain_step)
    m = cfg.model
    v, d = m.vit, m.decoder
    log(f"phase step {label}: {n_steps} two-pass steps eager, then graphed, "
        f"ViT dim {v.dim} depth {v.depth} heads {v.num_heads}, decoder "
        f"{d.dim}/{d.depth}/{d.num_heads}, {m.dtype}, batch "
        f"{cfg.batch_size}, attn_impl {m.attn_impl}, mlp_impl {m.mlp_impl}, "
        f"dec_mlp_impl {m.dec_mlp_impl}, mmixed_impl {m.mmixed_impl}, "
        f"remat_blocks {m.remat_blocks}, AVSIAM_MLP_BWD="
        f"{os.environ.get('AVSIAM_MLP_BWD')}, AVSIAM_LN="
        f"{os.environ.get('AVSIAM_LN')}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.time()
    state = init_state(cfg, gen, "cuda")
    batch = step_batch(cfg, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.model.parameters())
    log(f"  init: {n_params} parameters in {time.time() - t0:.2f} s")
    lr = cfg.opt.lr
    step = make_pretrain_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    steps = timed_steps("eager", step, state, batch, gen, lr, n_steps)
    launches = dict(kernels.LAUNCHES)
    peak, reserved = memory_gib()
    check_launches("eager", launches, per_step, n_steps)
    steady = median_after_first(steps)
    log(f"  phase {label} eager steady step: {steady:.1f} ms (median of "
        f"steps 1..{n_steps - 1}), peak memory {peak:.2f} GiB allocated, "
        f"{reserved:.2f} reserved")
    prof = profile_step(step, state, batch, gen, lr, steady)
    del step

    graphed = make_graphed_pretrain_step(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    warm = timed_steps("graphed warm-up", graphed, state, batch, gen, lr, 1)
    t1 = time.time()
    warm += timed_steps("graphed capture", graphed, state, batch, gen, lr, 1,
                        first=1)
    capture_s = time.time() - t1
    check_launches("graphed capture", graphed.launches, per_step, 1)
    replays = timed_steps("graphed replay", graphed, state, batch, gen, lr,
                          n_steps, first=2)
    gpeak, greserved = memory_gib()
    gsteady = median_after_first(replays)
    log(f"  phase {label} graphed steady step: {gsteady:.1f} ms (median of "
        f"replays 1..{n_steps - 1}; eager {steady:.1f}), warm-up "
        f"{(t1 - t0):.1f} s, capture and first replay {capture_s:.1f} s, "
        f"peak memory {gpeak:.2f} GiB allocated, {greserved:.2f} reserved")
    gprof = profile_step(graphed, state, batch, gen, lr, gsteady)
    check_replay_calls(prof, gprof)

    def share(p):
        return None if p is None else p["busy_ms"] / p["steady_ms"]

    def adam(p):
        return None if p is None else p["groups"].get("Adam", 0.0)

    report.setdefault("steps", {})[label] = dict(
        batch=cfg.batch_size, steps=steps, launches=launches,
        eager_steady_ms=steady, eager_peak_gib=peak,
        eager_reserved_gib=reserved, profile=prof,
        eager_busy_share=share(prof),
        eager_kernels=prof and prof["kernels"], eager_adam_ms=adam(prof),
        graphed_steps=warm + replays, graphed_steady_ms=gsteady,
        graphed_peak_gib=gpeak, graphed_reserved_gib=greserved,
        graphed_profile=gprof, graphed_busy_share=share(gprof),
        graphed_kernels=gprof and gprof["kernels"],
        graphed_adam_ms=adam(gprof), capture_s=capture_s)
    del graphed, state
    torch.cuda.empty_cache()
    return launches


PD64_WINDOW = 40    # data-fed replays timed as one span
PD64_MAX_DRAIN = 8  # batches the loader can hold ahead, with margin


def pd64_data(cfg, seed: int, n_batches: int):
    """PD64's data: P64's ``cfg`` with the pretrain recipe's audio config
    (``recipes/pretrain_audioset.sh``: noise and roll, no mixup, no
    SpecAugment), an ``AVDataset`` of ``n_batches`` x B 'synthetic' clips
    (index written under ``build/chip_smoke_data``), the epoch's shuffled
    indices and positions, and the train transform."""
    from pathlib import Path

    from avsiam_tpu_torch.configs import AudioConfig, replace
    from avsiam_tpu_torch.data.dataset import AVDataset, make_train_transform
    from avsiam_tpu_torch.data.samplers import shuffled_epoch_indices
    audio = AudioConfig(noise=True)  # recipes/pretrain_audioset.sh:24
    cfg = replace(cfg, audio=audio)
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_data"
    root.mkdir(parents=True, exist_ok=True)
    index = root / f"pd64_index_{n_batches}.json"
    index.write_text(json.dumps({"data": [
        {"wav": f"synthetic/{i}.wav", "labels": ""}
        for i in range(n_batches * cfg.batch_size)]}))
    im_res = cfg.model.vit.img_size
    ds = AVDataset(str(index), audio, frame_source="synthetic", mode="train",
                   im_res=im_res)
    idx, pos = shuffled_epoch_indices(len(ds), 0, seed, with_positions=True)
    return cfg, ds, idx, pos, make_train_transform(audio, im_res=im_res)


def time_data_pieces(cfg, seed: int) -> dict:
    """PD64's data pieces alone, on batches of its size: the host's
    assembly of one batch (host clock, median of three, on this thread),
    and the device time per call (``time_ms``) of the pinned batch's copy
    to the card, the draws and the train transform. Run with the kernel
    checks: a profiler session this short came back with no device records
    late in a long run."""
    from avsiam_tpu_torch.data.pipeline import host_batches
    from avsiam_tpu_torch.ops.augment import draw_transform
    cfg, ds, idx, _, transform = pd64_data(cfg, seed, 1)
    B, audio = cfg.batch_size, cfg.audio
    host_ms = []
    for _ in range(3):
        t0 = time.time()
        host = next(host_batches(ds, [idx[:B]], seed))
        host_ms.append((time.time() - t0) * 1e3)
    pinned = [torch.from_numpy(a).pin_memory() for a in host]
    dev = [t.to("cuda") for t in pinned]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    draws = draw_transform(audio, B, gen)
    out = dict(
        host_batch_ms=sorted(host_ms)[1],
        h2d_ms=time_ms(lambda: [t.to("cuda", non_blocking=True)
                                for t in pinned], iters=10),
        h2d_bytes=sum(t.numel() * t.element_size() for t in pinned),
        draw_ms=time_ms(lambda: draw_transform(audio, B, gen), iters=10),
        transform_ms=time_ms(lambda: transform(draws, *dev), iters=10))
    log(f"  PD64's data pieces, one batch of {B}: host assembly "
        f"{out['host_batch_ms']:.1f} ms by host clock "
        f"({out['host_batch_ms'] / B:.2f} ms a clip); device time a call: "
        f"copy to the card {out['h2d_ms']:.3f} ms "
        f"({out['h2d_bytes'] / 2**20:.1f} MiB), draws {out['draw_ms']:.3f} "
        f"ms, transform {out['transform_ms']:.3f} ms")
    return out


def run_data_fed(label, cfg, per_step, seed, report):
    """Phase PD64: the graphed ViT-B 'padded' pretrain step at B=64 (P64's
    configuration) fed by the port's loader: ``device_loader`` over
    ``pd64_data``'s clips in batches of 64 (host batches on its worker
    thread, pinned, copied on a side stream, transformed on the card).

    A warm-up step and the capture. Then the lead the loader built during
    them (up to three batches: two queued, one in the worker's hand) is
    drained: batches are taken without a step until one has to be waited
    for, so that the window measures the steady state and not that head
    start. The loader then holds nothing ahead and its worker has just
    begun a batch, as in the steady state of a loader that sets the pace;
    the next step waits for that whole batch and is left out of the
    window. Then ``PD64_WINDOW`` data-fed replays timed as one span (each
    step's wall time, its wait in ``next`` included): the rate is their
    clips over the span, the loader wait their mean time in ``next``, for
    the window and for each half. The kernel launches of every step,
    counted from 0 just before the warm-up, must be ``per_step`` times the
    steps, and every metric finite. Then one profiled data-fed step: the
    device's busy share of the window's mean step."""
    from avsiam_tpu_torch import kernels
    from avsiam_tpu_torch.data.pipeline import device_loader
    from avsiam_tpu_torch.data.samplers import batched
    from avsiam_tpu_torch.train.pretrain import (init_state,
                                                 make_graphed_pretrain_step)
    n_batches = 3 + PD64_MAX_DRAIN + PD64_WINDOW + 4
    cfg, ds, idx, pos, transform = pd64_data(cfg, seed, n_batches)
    B, audio, v = cfg.batch_size, cfg.audio, cfg.model.vit
    pieces = report["data_pieces"]
    log(f"phase data-fed {label}: P64's step (ViT dim {v.dim} depth "
        f"{v.depth}, {cfg.model.mmixed_impl}, {cfg.model.mlp_impl}, "
        f"{cfg.model.dtype}, batch {B}, graphed) fed by device_loader over "
        f"{len(ds)} synthetic clips, noise {audio.noise}, mixup "
        f"{audio.mixup}, freqm {audio.freqm}, timem {audio.timem}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = init_state(cfg, gen, "cuda")
    graphed = make_graphed_pretrain_step(cfg)
    loader = device_loader(ds, batched(idx, B), transform, draw_seed=seed,
                           seed=seed, device="cuda",
                           position_batches=batched(pos, B))
    lr = cfg.opt.lr
    steps = []

    def step(i, what):
        nonlocal state
        t0 = time.time()
        fb, img, _ = next(loader)
        t1 = time.time()
        state, metrics = graphed(state, (fb, img), gen, lr)
        metrics = {k: float(x) for k, x in metrics.items()}
        torch.cuda.synchronize()
        ms, wait = (time.time() - t0) * 1e3, (t1 - t0) * 1e3
        if not all(math.isfinite(x) for x in metrics.values()):
            raise AssertionError(f"{label} step {i}: non-finite metrics "
                                 f"{metrics}")
        steps.append(dict(metrics, ms=ms, loader_wait_ms=wait))
        log(f"  {label} {what} step {i}: " + " ".join(
            f"{k} {x:.5f}" for k, x in metrics.items())
            + f"  {ms:.1f} ms (loader wait {wait:.1f} ms)")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    step(0, "warm-up")
    step(1, "capture")
    # a take from a non-empty queue returns in about a millisecond; one
    # that waits for the worker, in a good part of an assembly
    drained, waited = 0, 0.0
    while waited < 0.25 * pieces["host_batch_ms"]:
        if drained == PD64_MAX_DRAIN:
            raise AssertionError(f"{label}: the loader's lead did not drain "
                                 f"in {drained} batches")
        t0 = time.time()
        next(loader)
        waited = (time.time() - t0) * 1e3
        drained += 1
    log(f"  {label}: drained the loader's lead in {drained} batches, the "
        f"last waited {waited:.1f} ms")
    step(2, "post-drain")
    t_start = time.time()
    for i in range(PD64_WINDOW):
        step(3 + i, "window")
    window_s = time.time() - t_start
    launches = dict(kernels.LAUNCHES)
    check_launches(label, launches, per_step, len(steps))
    peak, reserved = memory_gib()
    window = steps[3:]
    half = PD64_WINDOW // 2
    step_ms = 1e3 * window_s / PD64_WINDOW
    wait = sum(s["loader_wait_ms"] for s in window) / PD64_WINDOW
    halves = [dict(ms=sum(s["ms"] for s in w) / len(w),
                   loader_wait_ms=sum(s["loader_wait_ms"] for s in w)
                   / len(w)) for w in (window[:half], window[half:])]

    def data_step(st, _batch, g, lr_):
        fb_, img_, _ = next(loader)
        return graphed(st, (fb_, img_), g, lr_)

    prof = profile_step(data_step, state, None, gen, lr, step_ms)
    loader.close()
    p64_ms = report.get("steps", {}).get("P64", {}).get("graphed_steady_ms")
    busy = None if prof is None else prof["busy_ms"] / step_ms
    log(f"  phase {label} window: {PD64_WINDOW} data-fed steps in "
        f"{window_s:.3f} s: {step_ms:.1f} ms a step, "
        f"{1e3 * B / step_ms:.1f} clips/s, loader wait {wait:.1f} ms a step; "
        f"halves {halves[0]['ms']:.1f} / {halves[1]['ms']:.1f} ms a step, "
        f"wait {halves[0]['loader_wait_ms']:.1f} / "
        f"{halves[1]['loader_wait_ms']:.1f} ms; "
        + (f"busy {100 * busy:.1f}% of the step" if busy is not None
           else "busy share not measured"))
    if p64_ms is not None:
        log(f"  P64 on random batches in this run: {p64_ms:.1f} ms, "
            f"{1e3 * B / p64_ms:.1f} clips/s; the data costs "
            f"{step_ms - p64_ms:.1f} ms a step; host assembly alone "
            f"{pieces['host_batch_ms']:.1f} ms a batch (host clock); peak "
            f"memory {peak:.2f} GiB allocated, {reserved:.2f} reserved")
    report.setdefault("steps", {})[label] = dict(
        pieces, batch=B, steps=steps, launches=launches, drained=drained,
        window_steps=PD64_WINDOW, window_s=window_s,
        graphed_steady_ms=step_ms, clips_per_s=1e3 * B / step_ms,
        loader_wait_ms=wait, halves=halves, graphed_busy_share=busy,
        graphed_profile=prof, graphed_kernels=prof and prof["kernels"],
        graphed_peak_gib=peak, graphed_reserved_gib=reserved,
        p64_graphed_steady_ms=p64_ms)
    del graphed, state
    torch.cuda.empty_cache()
    return launches


def compare_eager_graphed(cfg, seed, n_steps: int = 3, tol: float = 1e-5):
    """Two states from one seed: ``n_steps`` eager steps of one against as
    many calls of the graphed step (warm-up, capture, replay) of the other,
    with draws from generators of one seed and the learning rate halved
    each step (so a replay must read the rate written before it). Each
    step's metrics and, at the end, every parameter and both Adams' moments
    must agree within ``tol`` relative (max |delta| / max |eager| per
    tensor); identical bits are expected. Returns the largest difference
    and where it was."""
    from avsiam_tpu_torch.train.pretrain import (init_state,
                                                 make_graphed_pretrain_step,
                                                 make_pretrain_step)
    log(f"phase eager-vs-graphed: {n_steps} eager steps against {n_steps} "
        f"graphed (warm-up, capture, replay), batch {cfg.batch_size}, "
        f"tolerance {tol} relative")
    runs = []
    for graphed in (False, True):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        state = init_state(cfg, gen, "cuda")
        batch = step_batch(cfg, gen)
        step = (make_graphed_pretrain_step(cfg) if graphed
                else make_pretrain_step(cfg))
        metrics = []
        for i in range(n_steps):
            state, m = step(state, batch, gen, cfg.opt.lr * 0.5 ** i)
            metrics.append(m)
        torch.cuda.synchronize()
        runs.append((state, metrics))
    (se, me), (sg, mg) = runs
    diffs = {}

    def hold(name, got, want):
        got, want = got.detach().float(), want.detach().float()
        scale = max(float(want.abs().max()), 1e-30)
        diffs[name] = float((got - want).abs().max()) / scale

    for i, (e, g) in enumerate(zip(me, mg)):
        for k in e:
            hold(f"step {i} {k}", g[k], e[k])
    for (name, pe), pg in zip(se.model.named_parameters(),
                              sg.model.parameters()):
        hold(name, pg, pe)
    for which, oe, og in (("adam1", se.opt1, sg.opt1),
                          ("adam2", se.opt2, sg.opt2)):
        names = {id(p): n for n, p in se.model.named_parameters()}
        for (pe, ste), (_, stg) in zip(oe.state.items(), og.state.items()):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                hold(f"{which} {key} {names[id(pe)]}", stg[key], ste[key])
    worst = max(diffs, key=diffs.get)
    n_equal = sum(d == 0.0 for d in diffs.values())
    log(f"  {len(diffs)} tensors compared, {n_equal} equal bit for bit; "
        f"largest relative difference {diffs[worst]:.3e} ({worst})")
    if diffs[worst] > tol:
        raise AssertionError(f"eager and graphed steps differ: {worst} "
                             f"{diffs[worst]:.3e} > {tol}")
    del runs, se, sg, me, mg, state, step
    torch.cuda.empty_cache()
    return dict(max_rel=diffs[worst], where=worst, tensors=len(diffs),
                equal=n_equal)


def padded_masks_at(cfg, gen):
    """{(B, N, H, D): [B, N] bool}: the keep masks of one 'padded' draw at
    ``cfg``'s batch (``models/cavmae.py:padded_keep_masks``), by the
    encoder attention shape each masks."""
    from avsiam_tpu_torch.models.cavmae import draw_masks, padded_keep_masks
    m = cfg.model
    B, heads = cfg.batch_size, m.vit.num_heads
    keep = padded_keep_masks(m, draw_masks(m, B, gen, "cuda", mae=False))
    return {(B, k.shape[1], heads, m.vit.dim // heads): k for k in keep}


def log_attention_totals(label, rows):
    """K1's and K2's time per step of phase ``label`` over ``rows``
    (``check_attention``'s), beside SDPA's and the bound."""
    def tot(key):
        return sum((r[key][0] if key.endswith("bound") else r[key])
                   * r["calls"] for r in rows)

    log(f"  attention per phase-{label} step at these shapes: K1 "
        f"{tot('fwd_ms'):.3f} ms (sdpa {tot('lib_fwd_ms'):.3f}, bound "
        f"{tot('fwd_bound'):.3f}), K2 {tot('bwd_ms'):.3f} ms (sdpa "
        f"{tot('lib_bwd_ms'):.3f}, bound {tot('bwd_bound'):.3f})")


def compare_forms(cfg, seed, batch: int = 8, tol: float = 2e-2):
    """Each contrastive form of ``cfg`` (ViT-B, full width, bf16) against
    'exact' on one shared set of 'exact' draws: the pooled ca and cv of
    'tconcat', 'bucketed' and 'packed' from the draws themselves, and of
    'padded' from the keep masks of those draws
    (``models/cavmae.py:exact_keep_masks``), each within ``tol`` relative
    (max |form - exact| / max |exact|). Returns {form: that error}."""
    from avsiam_tpu_torch.configs import replace
    from avsiam_tpu_torch.models.cavmae import (CAVMAEPretrain, draw_masks,
                                                exact_keep_masks)
    m = cfg.model
    log(f"phase forms: each contrastive form against 'exact' on one set of "
        f"draws, batch {batch}, tolerance {tol} relative")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    exact = CAVMAEPretrain(replace(m, mmixed_impl="exact"), "cuda", gen)
    v = m.vit
    audio = torch.randn((batch, v.audio_length, v.mel_bins), generator=gen,
                        device="cuda")
    imgs = torch.randn((batch, 3, v.img_size, v.img_size), generator=gen,
                       device="cuda")
    draws = draw_masks(exact.cfg, batch, gen, "cuda", mae=False)
    errs = {}
    with torch.no_grad():
        want = exact.forward_encoder_mmixed(audio, imgs, draws)
        for form in ("tconcat", "bucketed", "packed", "padded"):
            model = CAVMAEPretrain(replace(m, mmixed_impl=form), "cuda", gen)
            model.load_state_dict(exact.state_dict())
            if form == "padded":
                keep_a, keep_v = exact_keep_masks(exact.cfg, draws)
                got = (model._encode_contrastive(
                           model.vit.embed_audio(audio), "a", keep_a),
                       model._encode_contrastive(
                           model.vit.embed_video(imgs), "v", keep_v))
            else:
                got = model.forward_encoder_mmixed(audio, imgs, draws)
            errs[form] = max(rel_err(g, w)[1] for g, w in zip(got, want))
            log(f"  {form}: ca, cv rel err {errs[form]:.2e} against 'exact' "
                f"(<= {tol})")
            del model
    if max(errs.values()) > tol:
        raise AssertionError(f"forms against 'exact': {errs} > {tol}")
    del exact
    torch.cuda.empty_cache()
    return errs


def check_at_shapes(label, cfg, shapes: Shapes, gen):
    """Every kernel of phase ``label``'s step against its plain version at
    the step's attention and MLP shapes (``main_path_shapes``), the ones the
    kernels phase does not time: K1/K2 or K5/K6 by ``attention_route``
    (under a random key mask where the step masks keys), K3 under 'lnfres',
    K4 with the hidden under 'fres', K4 and K7 (with K9 twice) and K9 alone
    under 'fused'. Untimed."""
    from avsiam_tpu_torch.ops import attention as pat
    from avsiam_tpu_torch.ops import mlp as pm
    errs = {}
    for b, n, heads, hd in shapes.attn:
        C = heads * hd
        x = torch.randn((b, n, 3 * C), generator=gen, device="cuda"
                        ).bfloat16()
        do = torch.randn((b, n, C), generator=gen, device="cuda").bfloat16()
        kv = (random_key_mask(b, n, gen) if (b, n, heads, hd) in shapes.masked
              else None)
        route = pat.attention_route(cfg.model.attn_impl, C, heads)
        name = (f"{route} b={b} N={n} H={heads} D={hd} "
                f"mask={int(kv is not None)}")
        xr = x.float().requires_grad_(True)
        if route == "token_major":
            out, stats = pat.attention_fwd_kernel(x, heads, kv)
            dx = pat.attention_bwd_kernel(x, out, stats, do, heads, kv)
            ref = pat.attention_reference(xr, heads, kv)
            (gref,) = torch.autograd.grad(ref, xr, do.float())
        else:
            q, k, v = x.view(b, n, 3, heads, hd).unbind(2)
            out, stats = pat.attention_hm_fwd_kernel(q, k, v, kv)
            dx = torch.stack(pat.attention_hm_bwd_kernel(
                q, k, v, out, stats, do.view(b, n, heads, hd), kv), dim=2)
            qr, kr, vr = xr.view(b, n, 3, heads, hd).unbind(2)
            ref = pat.attention_hm_reference(qr, kr, vr, kv)
            (gref,) = torch.autograd.grad(ref, xr, do.float().view_as(ref))
            gref = gref.view_as(dx)
        errs[name] = max(rel_err(out, ref)[1], rel_err(dx, gref)[1])
        del ref, gref, xr
    for t, d, h, impl in shapes.mlp:
        o = mlp_operands(gen, t, d, h)
        x, w1, b1, w2, b2, do = (o[k] for k in ("x", "w1", "b1", "w2", "b2",
                                                "do"))
        f = {k: val.float() for k, val in o.items()}
        name = f"{impl} T={t} D={d} H={h}"
        got, want = [], []
        if impl == "lnfres":
            g = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
            bl = 0.1 * torch.randn(d, generator=gen, device="cuda")
            got += pm.ln_mlp_fwd_kernel(x, g, bl, w1, b1, w2, b2, 1e-5)
            want += pm.ln_mlp_reference(f["x"], g, bl, f["w1"], b1, f["w2"],
                                        b2, 1e-5)
        if impl in ("fused", "fres"):
            got += pm.mlp_fwd_kernel(x, w1, b1, w2, b2, True)
            want += pm.mlp_fwd_reference(f["x"], f["w1"], b1, f["w2"], b2,
                                         save_hpre=True)
        if impl == "fused":
            got += pm.mlp_bwd_kernel(x, w1, b1, w2, do)
            want += pm.mlp_bwd_reference(f["x"], f["w1"], b1, f["w2"],
                                         f["do"])
            gh = torch.randn((t, h), generator=gen, device="cuda").bfloat16()
            for a_, g_ in ((x, gh), (gh, do)):  # dw1's and dw2's operands
                got += pm.weight_grads_kernel(a_, g_)
                want += pm.weight_grads_reference(a_.float(), g_.float())
        if got:
            errs[name] = max(rel_err(g_, w_)[1] for g_, w_ in zip(got, want))
        del got, want
    for name, e in errs.items():
        log(f"  {label} shape {name}: rel err {e:.1e} (<= {ATTN_TOL})")
        if e > ATTN_TOL:
            raise AssertionError(f"{label} {name}: rel err {e:.3e} > "
                                 f"{ATTN_TOL}")
    return errs


# kernel-name fragments -> the category a profiled step's device time is
# summed under (first match wins)
KERNEL_GROUPS = (
    ("K1 attention fwd", ("attn_fwd_kernel",)),
    ("K2 attention bwd", ("attn_bwd_",)),
    ("K5 attention_hm fwd", ("attn_hm_fwd_kernel",)),
    ("K6 attention_hm bwd", ("attn_hm_bwd_",)),
    ("K10 ln bwd", ("ln_bwd_rows_kernel", "ln_bwd_cols_kernel")),
    ("K3 LN rows", ("ln_mlp_rows_kernel",)),
    ("K3/K4 fc1 pass", ("mlp_fc1_kernel",)),
    ("K3/K4 fc2 pass", ("mlp_fc2_kernel",)),
    ("K7/K8 gh pass", ("mlp_gh_kernel", "colsum_fold")),
    ("K7/K8 dx pass", ("mlp_dx_kernel",)),
    ("K9 mlp dw", ("mlp_dw_",)),
    ("K3/K4/K7/K8 partial-sum epilogue", ("mlp_epilogue",)),
    ("GEMM (cuBLAS)", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
    ("Adam", ("multi_tensor_apply", "adam")),
)


def profile_step(step, state, batch, gen, lr, steady_ms, top: int = 8):
    """One more step under torch.profiler: device time by kernel group, the
    device's busy share of the steady (unprofiled) step time, the number
    of kernels launched, the calls of each of the port's kernels (the
    groups K1-K10), and the ``top`` kernels by device time and then the
    Adam group's others (name, calls, ms, group). A user annotation's
    device range (the eager ``Optimizer.step#Adam.step``) spans kernels
    counted on their own and is left out. Runs after the launch counts
    were read."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch, gen, lr)
        torch.cuda.synchronize()
    groups, kernels_run, per_kernel = {}, 0, []
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.is_user_annotation):
            continue
        name = e.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), "other (elementwise, "
                     "reductions, copies)")
        ms = e.self_device_time_total / 1e3
        groups[group] = groups.get(group, 0.0) + ms
        kernels_run += e.count
        per_kernel.append((e.key, e.count, ms, group))
    per_kernel.sort(key=lambda k: -k[2])
    shown = per_kernel[:top] + [k for k in per_kernel[top:]
                                if k[3] == "Adam"]
    busy = sum(groups.values())
    if busy == 0.0:
        log("  profile: the profiler recorded no device time (not measured)")
        return None
    log(f"  profile of one step: device busy {busy:.1f} ms of the steady "
        f"{steady_ms:.1f} ms step ({100 * busy / steady_ms:.1f}%), "
        f"{kernels_run} kernels")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g:38s} {ms:8.2f} ms  {100 * ms / busy:5.1f}% of busy")
    log(f"  its {top} largest kernels, then Adam's others:")
    for name, calls, ms, group in shown:
        log(f"    {ms:8.2f} ms {calls:6d} calls  [{group[:12]}] {name[:160]}")
    calls = {}
    for name, n, _, group in per_kernel:
        if group.startswith("K"):
            calls[name] = calls.get(name, 0) + n
    return dict(busy_ms=busy, steady_ms=steady_ms, kernels=kernels_run,
                groups=groups, top=shown, calls=calls)


def check_replay_calls(eager, graphed):
    """A replay runs no wrapper, so its launch counts are the capture's:
    what shows that a replay ran the port's kernels is the profiler. Each
    kernel's calls in the profiled replay must equal its calls in the
    profiled eager step."""
    if eager is None or graphed is None:
        raise AssertionError("the profiler recorded no device time: the "
                             "replay's kernel calls cannot be checked")
    total = sum(graphed["calls"].values())
    log(f"  profiled replay: {len(graphed['calls'])} kernels of the port, "
        f"{total} calls (eager step {sum(eager['calls'].values())})")
    if graphed["calls"] != eager["calls"] or total == 0:
        diff = {k: (eager["calls"].get(k), graphed["calls"].get(k))
                for k in set(eager["calls"]) | set(graphed["calls"])
                if eager["calls"].get(k) != graphed["calls"].get(k)}
        raise AssertionError(f"the replay's kernel calls differ from the "
                             f"eager step's (eager, replay): {diff}")


def run_reference(label, impls, seed, report, batch: int = 2):
    """Kernels in bf16 on the card against the plain versions in float32 on
    the CPU: full width, depth 1, same weights and draws, in the MLP impls
    of step phase ``label``."""
    from avsiam_tpu_torch.configs import replace
    from avsiam_tpu_torch.models.cavmae import CAVMAEPretrain, draw_masks
    loss_tol, cos_tol = 2e-2, 0.99
    cfg = phase_config(impls, depth=1, dec_depth=1).model
    log(f"phase reference {label}: depth 1, batch {batch}, {impls}, "
        f"AVSIAM_MLP_BWD={os.environ.get('AVSIAM_MLP_BWD')}, AVSIAM_LN="
        f"{os.environ.get('AVSIAM_LN')}: bf16 "
        f"kernels on the card vs float32 plain versions on the CPU (loss rel "
        f"err <= {loss_tol}, gradient cosine >= {cos_tol})")
    gpu = CAVMAEPretrain(cfg, "cuda",
                         torch.Generator(device="cuda").manual_seed(seed + 1))
    cpu = CAVMAEPretrain(replace(cfg, dtype=torch.float32), "cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    cgen = torch.Generator().manual_seed(seed + 2)
    v = cfg.vit
    audio = torch.randn((batch, v.audio_length, v.mel_bins), generator=cgen)
    imgs = torch.randn((batch, 3, v.img_size, v.img_size), generator=cgen)
    draws = draw_masks(cfg, batch, cgen, "cpu")
    draws_gpu = draws.map(lambda t: t.cuda())
    names = ("loss", "loss_mae", "loss_mae_a", "loss_mae_v", "loss_c")
    results = {}
    for part, mae_w, con_w in (("contrastive", 0.0, 1.0), ("mae", 1.0, 0.0)):
        got = {}
        for model, dev, d in ((gpu, "cuda", draws_gpu), (cpu, "cpu", draws)):
            model.zero_grad(set_to_none=True)
            out = model(audio.to(dev), imgs.to(dev), mae_loss_weight=mae_w,
                        contrast_loss_weight=con_w, draws=d)
            out[0].backward()
            grads = torch.cat([p.grad.double().cpu().flatten()
                               for _, p in model.named_parameters()
                               if p.grad is not None])
            got[dev] = ({n: float(out[i].detach()) for i, n in
                         zip((0, 1, 2, 3, 4), names)}, grads)
        (lg, gg), (lc, gc) = got["cuda"], got["cpu"]
        rel = {n: abs(lg[n] - lc[n]) / max(abs(lc[n]), 1e-6) for n in names
               if lc[n] != 0.0}
        cos = float(torch.nn.functional.cosine_similarity(gg, gc, dim=0))
        log(f"  {part}: kernel {lg} plain {lc} rel err "
            f"{max(rel.values()):.2e}; gradient cosine {cos:.6f} over "
            f"{gg.numel()} values")
        if max(rel.values()) > loss_tol or not cos >= cos_tol:
            raise AssertionError(f"reference {label} {part}: loss rel err "
                                 f"{rel}, gradient cosine {cos}")
        results[part] = dict(kernel=lg, plain=lc, rel=rel, grad_cos=cos)
    report.setdefault("reference", {})[label] = results


if __name__ == "__main__":
    sys.exit(main())
