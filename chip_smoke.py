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
   widths 8, 16 and 128 (C 128, 128, 256) and K5/K6 at 8, 16, 48 and 128
   and, on their wide path, 136, 192 and 256, with and without masked
   keys; K5/K6 at D 192 and 256 also timed beside SDPA.
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
   E. ViT-H/16 (``pretrain_config('cav-mae-huge')``: dim 1280, 16 heads
      of 80; decoder 512/8/16) at encoder depth 16 of 32 (the kernels
      phase times its shapes at the full depth), ``attn_impl='pallas'``,
      ``mlp_impl='fused'`` (K5, K6 in the encoders, K1, K2 in the decoder;
      K4 and K7, with K9, at D 1280 and in the decoder);
   A64. A at the JAX bench's batch of 64 (``bench.py:81-84``);
   P64. A64 in the 'padded' form, the JAX config's default (K1/K2 with a
      key mask per sample at full length, K3);
   H64. E at B=64 with ``remat_blocks``, at encoder depth 16 of 32 (K5,
      K6; K1, K2 in the decoder;
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
   AO. The audio-only finetune model (``models/audio_only.py``) at ViT-B
      width (11 + 1 blocks, 512 audio tokens), 527 classes, B=64, bf16,
      'auto': three eager forward and BCE-backward steps, exactly 12 K1,
      12 K3 and 12 K2 a step; then at depth 2, B=2, the bf16 kernels on
      the card against the float32 plain model on the CPU (loss within
      2e-2, gradient cosine at least 0.99) with ``tr_pos=False``, whose
      position table takes no gradient (``run_audio_only``).
   TOME. One ViT-B block with ToMe's r > 0 at B=64, audio N=512 and video
      N=196, r 16 and 64, bf16 'auto' (K1, then K3 over the merged tokens)
      against the float32 plain block on the card, by pieces: attention
      and metric, the merge and MLP residual under one shared plan, the
      token mass, r slots dropped a sample, the plans' agreement printed
      (``run_tome``).
   PD64. P64's graphed step fed by the port's loader (``device_loader``
   over an ``AVDataset`` of 'synthetic' clips, the pretrain recipe's audio
   config): warm-up and capture, the loader's lead drained, then a window
   of 40 data-fed replays timed as one span (rate, loader wait, each
   half), the launch counts (from 0 just before, P64's per step), a
   profiled data-fed step (busy share), beside P64 on random batches. The
   host's assembly of one batch, and the device time of its copy to the
   card, the draws and the transform, are timed alone with the kernel
   checks.
   CLI64. The port's runner (``python -m avsiam_tpu_torch.cli.pretrain``'s
   ``main``, in this process) on the AudioSet pretrain recipe's command
   line (``recipes/pretrain_audioset.sh``; 'synthetic' clips, 8 steps an
   epoch, a 128-clip validation index): (a) epoch 1, (b) ``--resume`` to
   epoch 2, (c) epochs 1-2 straight; the launch counts, finite losses,
   resumed against straight within 1e-5 (the same bits expected), one lr
   tensor for both Adams after the restore, the checkpoints loading back
   (``run_cli``).
   FT64. The port's finetune runner (``python -m avsiam_tpu_torch.cli.
   finetune``'s ``main``, in this process) on the VGGSound finetune
   recipe's command line (``recipes/ft_vggsound.sh``: ViT-B, 'mm_grad',
   CE, B=64, 309 classes; 'synthetic' clips, 8 steps an epoch, 2 epochs,
   64 validation and eval clips of 10 frames, ``--wa``), from CLI64's
   ``best_audio_model``: finite losses and metrics in every
   ``result.csv`` row, each kernel launched as often as the steps'
   branches (26 K1 and 26 K3 a forward, 26 or 12 K2 a backward) and the
   10-frame eval batches imply (``run_ft_cli``). The kernels phase holds
   K1/K2 at the fusion layers' (2, 708, 12, 64) and K3 at their rows in
   a step (64 x 708), and at the end of the script in the eval (640 x
   708, its plain version and composite untimed).
   RET. The port's retrieval runner (``python -m avsiam_tpu_torch.cli.
   retrieval``'s ``main``, in this process) on FT64's
   ``best_audio_model`` over FT64's 64 eval clips, with the VGGSound
   recipe's model, classes, target length and normalisation, batch 64:
   R@1/R@5/R@10/MR each way, the launches of one 'retrieval' forward a
   batch (24 K1, 24 K3); then the same clips' features through the
   kernels against the float32 plain versions on the card, within 2e-2,
   and the forward's device time each way (``run_retrieval``).
   DP1. This script as its own worker (``--dp1-worker``) under ``python
   -m torch.distributed.run --standalone --nproc_per_node=1``: one rank,
   NCCL (the host has one card, and NCCL takes one rank a device). (a)
   P64's graphed step with the collectives in the graph, three steps
   from the eager-vs-graphed check's seed, state, batch and draws: every
   parameter, Adam moment, step count and metric the same bits as that
   check's single-process graphed run; five replays timed and one
   profiled (the NCCL kernels' calls and device time). (b) The pretrain
   runner on CLI64 (a)'s command line: ``result.csv`` and every
   parameter the same bits as CLI64 (a)'s. Launch counts exact in both
   (``run_dp1``).
   TP2. Tensor parallelism: this script as two workers
   (``--tp2-worker``) under ``python -m torch.distributed.run
   --standalone --nproc_per_node=2``, a mesh of data 1 x model 2 on the
   one card (gloo, which takes more ranks than cards). ViT-H at encoder
   depth 8 ('pallas', 'fused') and ViT-B ('lnfres'), B=8, three eager
   steps each from one seed, each rank holding its shards: the metrics,
   the gathered parameters and Adam moments against the same steps in
   this process (bf16 tolerances, ``TP2_*``), the replicated parameters
   the same bits on both ranks, each rank's launches equal to one
   process's, each kernel and the MLP kernels' float32 partial forms
   against their plain versions at a rank's shapes, one step profiled;
   then the pretrain runner on CLI64 (a)'s command line cut to two steps
   and one validation batch, with ``--mesh_model 2``: ``result.csv``
   against the same command line's in this process, its
   ``train_state.1`` loaded here by one process (``run_tp2``).
   ``--tp2-fault row-sum|qkv-contiguous|none`` runs only TP2's steps with
   that fault planted in the workers and prints what the limits read.
4. reference: for configurations A-E, P64 and H64, one contrastive and one MAE
   forward/backward at full width, depth 1, batch 2, through the kernels in
   bf16 on the card and through the plain versions in float32 on the CPU,
   from the same weights and draws: losses and gradients must agree within
   the stated tolerances. FTR: the finetune step in each 'mm_grad' branch
   the same way (``run_ft_reference``). MEM, beside them: ``python -m
   avsiam_tpu_torch.cli.memory_probe --model cav-mae-base --batch-size 8
   --steps 3`` in a process of its own, its JSON line, its peak within 10%
   of phase A's eager peak (``start_memory_probe``,
   ``check_memory_probe``).

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


def event_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Device time of one call of ``fn``, by CUDA events around ``iters``
    back-to-back calls, for a call of many kernels that keeps the card
    busy (a whole block: ``time_ms``'s profiler sessions came back with a
    record count no multiple of the calls there, three times a call)."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def plain_ms(fn):
    """``time_ms`` of a plain float32 version: 3 calls after 1 warm-up. A
    plain version's time is no yardstick (the kernels and the library
    calls keep ``time_ms``'s 20 after 3), and its sessions cost the
    script's time."""
    return time_ms(fn, iters=3, warmup=1)


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


def main_path_shapes(cfg, batch: int, mae: bool = True,
                     model: int = 1) -> Shapes:
    """Distinct (kernel-call) shapes of one pretrain step and their calls per
    step (``mae=False``: of its contrastive pass alone), in the
    configuration's contrastive form: each block call's
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
    parts, nor ``mm_layer_1/2``'s or the decoder's). ``model``: the shapes
    one rank of a model axis of that size gives its kernels (tensor
    parallelism: each attention's heads and each MLP's hidden width split
    ``model`` ways, the head width and every call as they are)."""
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
        key = (b, n, heads // model, dim // heads)
        count(s.attn, key, calls)
        if again:
            count(s.again_attn, key, calls)
        if masked:
            s.masked.add(key)

    def mlp(rows, dim, hidden, calls, impl, again=False):
        key = (rows, dim, hidden // model, mlp_route(impl, dim, hidden))
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
            count(s.mlp, (sum(rows), C, enc_h // model,
                          "fres" if impl == "lnfres" else impl), v.depth)
            for r in rows:  # norm1, norm2 and the final norm, routed
                count(s.ln, (r, C), 2 * v.depth + 1)
    if not mae:
        return s
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


def forward_launches(cfg, shapes: Shapes):
    """Each kernel's launches of one forward, no backward, over ``shapes``:
    attention's forward kernel by ``attention_route``, the MLP's forward
    kernels (the eval step's forward)."""
    from avsiam_tpu_torch import kernels
    from avsiam_tpu_torch.ops.attention import attention_route
    out = {k: 0 for k in kernels.LAUNCHES}
    for (_, _, heads, hd), calls in shapes.attn.items():
        route = attention_route(cfg.model.attn_impl, heads * hd, heads)
        for k in ATTN_KERNELS[route][:1]:
            out[k] += calls
    for row in mlp_shape_launches(shapes.mlp, False).values():
        for k, n in row.items():
            if k in MLP_FWD_KERNELS:
                out[k] += n
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
        plain_fwd = plain_ms(lambda: attention_reference(xqkv.float(), heads,
                                                        kv))
        ref_g = attention_reference(x32, heads, kv)
        plain_bwd = plain_ms(lambda: torch.autograd.grad(
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


def check_ln_mlp(shapes, gen, eps: float = 1e-5, timed: bool = True):
    """K3 at each (rows, D, H) of ``shapes`` ({(rows, D, H, impl): calls
    per step}) against its plain version; times of kernel (and of its
    passes), plain version and the composite 'dense' yardstick (not one
    call; neither unless ``timed``), and their sums over a phase-A
    step."""
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
        del ref, href
        parts = time_ms(lambda: ln_mlp_fwd_kernel(x, g, bl, w1, b1, w2, b2,
                                                  eps), by_kernel=True)
        ms, split = sum(parts.values()), fwd_pass_ms(parts)
        plain = composite = None
        if timed:
            plain = plain_ms(lambda: ln_mlp_reference(
                x.float(), g, bl, w1.float(), b1, w2.float(), b2, eps))
            composite = time_ms(lambda: dense_ln_mlp(x, g, bl, w1, b1, w2,
                                                     b2, eps))
        bd = bound_ms(4 * t * d * h, 2 * (2 * t * d + 2 * d * h + t * h))
        rows.append(dict(T=t, D=d, H=h, calls=calls, out_err=oerr,
                         out_rel=orel, hpre_err=herr, hpre_rel=hrel, ms=ms,
                         pass_ms=split, plain_ms=plain,
                         composite_ms=composite, bound=bd))
        yardsticks = ("plain, composite not timed" if plain is None else
                      f"plain {plain:.4f} composite {composite:.4f} "
                      f"({ms / composite:.2f}x)")
        log(f"  ln_mlp T={t:5d} D={d} H={h} x{calls:3d}/step  err out "
            f"{oerr:.2e} (rel {orel:.1e} <= {MLP_TOL}) hidden {herr:.2e} "
            f"(rel {hrel:.1e})  {ms:.4f} ms [{fmt_passes(split)}]"
            f" {yardsticks} bound {bd[0]:.4f} ({100 * bd[0] / ms:.1f}%)")
    if not any(r["calls"] for r in rows):
        return rows
    tot = {k: sum(r[k] * r["calls"] for r in rows if r["calls"])
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
            fwd=plain_ms(lambda: pm.mlp_fwd_reference(f["x"], f["w1"], b1,
                                                      f["w2"], b2)),
            fwd_hpre=plain_ms(lambda: pm.mlp_fwd_reference(
                f["x"], f["w1"], b1, f["w2"], b2, save_hpre=True)),
            bwd=plain_ms(lambda: pm.mlp_bwd_reference(f["x"], f["w1"], b1,
                                                      f["w2"], f["do"])),
            bwd_dx=plain_ms(lambda: pm.mlp_bwd_dx_reference(
                f["x"], f["w1"], b1, f["w2"], f["do"])),
            dw=plain_ms(lambda: pm.weight_grads_reference(f["x"], gh.float()))
            + plain_ms(lambda: pm.weight_grads_reference(act.float(),
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
        plain = plain_ms(lambda: ln_bwd_reference(x.float(), dy.float(),
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
            fwd=plain_ms(lambda: pat.attention_hm_reference(*f, kv)),
            bwd=plain_ms(lambda: pat.attention_hm_bwd_stats_reference(
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
# multiple of 128, K5/K6 up to 128 in the tiles and above on the wide path
# (K1/K2 also take the first and the fourth)
WIDTHS_TM = ((2, 512, 16, 8), (2, 512, 8, 16), (2, 512, 2, 128))
WIDTHS_HM = ((2, 512, 16, 8), (2, 512, 8, 16), (2, 512, 4, 48),
             (2, 512, 2, 128), (2, 512, 4, 136), (2, 512, 4, 192),
             (2, 512, 3, 256))


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
        return sum(r[key] * r["calls"] for r in rows if r["calls"])

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
# the encoder depth a step phase is cut to (H64 runs 16 of ViT-H's 32
# blocks, to leave the script's time for the finetune phases, and E, for
# phases AO, TOME and MEM); the kernels phase keeps the full depth's
# shapes and calls per step
PHASE_DEPTH = {"H64": 16, "E": 16}
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
    ``depth`` cuts the encoders' depth and ``dec_depth`` the decoder's."""
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
        m = replace(m, vit=replace(m.vit, depth=depth))
    if dec_depth is not None:
        m = replace(m, decoder=replace(m.decoder, depth=dec_depth))
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
    ap.add_argument("--dp1-worker", default=None, metavar="PATH",
                    help="run as phase DP1's worker under torch.distributed."
                         "run, writing its results to PATH")
    ap.add_argument("--tp2-worker", default=None, metavar="PATH",
                    help="run as one of phase TP2's two workers under "
                         "torch.distributed.run; rank 0 writes its results "
                         "to PATH")
    ap.add_argument("--tp2-fault", default=None, choices=TP2_FAULTS,
                    help="run only phase TP2's steps with this fault planted "
                         "in its workers, and print what its limits read: "
                         "exits 0 where a planted fault breaks a limit and "
                         "'none' breaks none")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if args.dp1_worker:
        return dp1_worker(args.dp1_worker, args.seed)
    if args.tp2_worker:
        return tp2_worker(args.tp2_worker, args.seed, args.tp2_fault)
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

    if args.tp2_fault:
        report = {"device": card}
        run_tp2("TP2", args.seed, report, fault=args.tp2_fault)
        log(card)
        print(json.dumps({"tp2_fault": args.tp2_fault, "runs": {
            run: {k: r[k] for k in (
                "metric_rel", "acc_diff", "moment_max_rel",
                "moment_median_rel", "loose_share", "param_max_over_lr",
                "replicated", "replicated_differ", "breaches")}
            for run, r in report["steps"]["TP2"]["runs"].items()}}))
        return 0

    phases = {}
    for label, impls, split, ln, n_steps, batch in PHASES:
        cfg = phase_config(impls, depth=PHASE_DEPTH.get(label), batch=batch)
        phases[label] = dict(impls=impls, cfg=cfg, split=split, ln=ln,
                             n_steps=n_steps,
                             shapes=main_path_shapes(cfg, cfg.batch_size),
                             kernel_shapes=main_path_shapes(phase_config(
                                 impls, batch=batch), batch))
    attn_shapes, mlp_shapes = phases["A"]["shapes"][:2]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    report = {"device": card, "kernel_resources": resources}
    log("phase kernels: each kernel against its plain version")
    # beyond the B=8 step's shapes: the B=64 step's shortest chunks, and
    # random key masks
    extra = [((2, 102, 12, 64), False), ((2, 39, 12, 64), False),
             ((2, 177, 12, 64), True), ((2, 708, 16, 32), True),
             ((2, 708, 12, 64), False)]  # the finetune fusion layers
    attn_rows = check_attention(attn_shapes, extra, gen)
    # K3 also at ViT-L's (D 1024, H 4096) and ViT-H's (1280, 5120) encoder
    # shapes, which no step phase runs under 'lnfres'; the MLP family at
    # ViT-L's beside phase E's ViT-H shapes
    wide = [(t, d, 4 * d) for d in (1024, 1280) for t in (156, 1024, 1416)]
    # and at the rows of the finetune fusion layers in FT64's steps (64 x
    # 708); the 10-frame eval's (640 x 708) come last, below
    mlp_rows = check_ln_mlp({**mlp_shapes, **{
        (t, d, h, "lnfres"): 0 for t, d, h in wide + [(64 * 708, 768,
                                                       3072)]}}, gen)
    fam_rows = check_mlp_family(
        {p: mlp_shape_launches(phases[p]["kernel_shapes"][1],
                               phases[p]["split"])
         for p in "BCE"}, [k for k in wide if k[1] == 1024], gen)
    # K10 at phase D's LN shapes and at ViT-H's width (phase E's encoder
    # LN shapes, which run the torch-ops backward there)
    ln_shapes = dict(phases["D"]["shapes"][2])
    ln_shapes.update({k: 0 for k in phases["E"]["kernel_shapes"][2]
                      if k[1] == 1280})
    ln_rows = check_ln_bwd(ln_shapes, gen)
    e = phases["E"]
    # and K5/K6 above head width 128 (the wide path), timed beside SDPA
    hm_rows = check_attention_hm(
        head_major_shapes(e["cfg"], e["kernel_shapes"][0]),
        [((2, 177, 16, 80), True), ((2, 196, 12, 64), False),
         ((2, 177, 12, 64), True), ((2, 512, 4, 192), False),
         ((2, 512, 3, 256), False)], gen)
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
    log("phase widths: K1/K2 at D 8, 16, 128; K5/K6 at D 8, 16, 48, 128, "
        "136, 192, 256")
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
    dp1_steps, dp1_cli = {}, {}  # DP1's references
    for label, p in phases.items():
        t1 = time.time()
        with env_flags(p["split"], p["ln"]):
            launches[label] = run_steps(
                label, p["cfg"], expected_launches(
                    p["cfg"], p["shapes"], p["split"], p["ln"], 1),
                args.seed, report, p["n_steps"])
        if label in ("A", "P64"):
            report.setdefault("eager_vs_graphed", {})[label] = \
                compare_eager_graphed(p["cfg"], args.seed, keep=dp1_steps
                                      if label == "P64" else None)
        log(f"phase {label}: {time.time() - t1:.1f} s")
    log(f"step phases done at {time.time() - t0:.0f} s")
    t1 = time.time()
    launches["AO"] = run_audio_only("AO", args.seed, report)
    launches["TOME"] = run_tome("TOME", args.seed, report)
    log(f"phases AO and TOME done at {time.time() - t0:.0f} s, in "
        f"{time.time() - t1:.1f} s")
    p64 = phases["P64"]
    launches["PD64"] = run_data_fed(
        "PD64", p64["cfg"], expected_launches(p64["cfg"], p64["shapes"],
                                              False, False, 1),
        args.seed, report)
    pretrain_params = kernels.BUILD_DIR.parent / "chip_smoke_pretrain_params"
    launches["CLI64"] = run_cli("CLI64", args.seed, report,
                                keep_params=pretrain_params,
                                reference=dp1_cli)
    ft_params = kernels.BUILD_DIR.parent / "chip_smoke_ft_params"
    try:
        launches["FT64"] = run_ft_cli("FT64", args.seed, report,
                                      pretrain_params, keep_params=ft_params)
        launches["RET"] = run_retrieval("RET", args.seed, report, ft_params)
    finally:
        pretrain_params.unlink(missing_ok=True)
        ft_params.unlink(missing_ok=True)
    launches["DP1"] = run_dp1("DP1", args.seed, report, dp1_steps, dp1_cli)
    launches["TP2"] = run_tp2("TP2", args.seed, report)
    log(f"runner phases done at {time.time() - t0:.0f} s")
    mem = start_memory_probe("MEM")
    try:
        report["forms_vs_exact"] = compare_forms(phases["A"]["cfg"],
                                                 args.seed)
        for label in REFERENCE_PHASES:
            p = phases[label]
            with env_flags(p["split"], p["ln"]):
                run_reference(label, p["impls"], args.seed, report)
        run_ft_reference(args.seed, report)
        log(f"reference phases done at {time.time() - t0:.0f} s")
        check_memory_probe("MEM", report,
                           report["steps"]["A"]["eager_peak_gib"], mem)
    finally:
        if mem[0].poll() is None:
            mem[0].kill()
            mem[0].wait()
    log(f"phase MEM done at {time.time() - t0:.0f} s")
    # K3 at the 10-frame eval's fusion rows (640 x 708, which cross every
    # row tile and reach the largest row index FT64 gives it), last, and
    # its plain version and composite not timed: their profiler sessions
    # would run for seconds, and after such a session every later one on
    # the card came back one device record short, each then run three times
    log("phase kernels at the eval's fusion rows: K3 at 453,120 rows")
    report["ln_mlp_ft_eval"] = check_ln_mlp(
        {(640 * 708, 768, 3072, "lnfres"): 0}, gen, timed=False)
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
        "forms_vs_exact_max_rel": report["forms_vs_exact"],
        "cli64": {k: report["steps"]["CLI64"][k] for k in (
            "resume_max_rel", "resume_equal", "resume_tensors",
            "rows_max_rel")},
        "ft64": {k: report["steps"]["FT64"][k] for k in (
            "wall_s", "peak_gib", "branches", "wa_s", "eval_acc")},
        "ftr": {b: {k: r[k] for k in ("rel", "grad_cos")}
                for b, r in report["reference"]["FTR"].items()},
        "dp1": {k: report["steps"]["DP1"][k] for k in (
            "graphed_steady_ms", "nccl_ms", "nccl_calls", "state_tensors",
            "params_equal", "runner_s")},
        "ret": {k: report["steps"]["RET"][k] for k in (
            "rows", "feature_rel_err", "forward_ms", "plain_forward_ms")},
        "ao": {k: report["steps"]["AO"][k] for k in (
            "eager_steady_ms", "eager_peak_gib", "reference")},
        "tome": [{k: r[k] for k in ("modality", "N", "r", "errs",
                                    "same_plan", "same_fate", "ms",
                                    "plain_ms")}
                 for r in report["steps"]["TOME"]["rows"]],
        "mem": {k: report["steps"]["MEM"][k] for k in (
            "params_million", "optimizer_state_million", "memory",
            "peak_gib", "a_rel", "wall_s")},
        "tp2": {run: {k: r[k] for k in (
            "depth", "metric_rel", "loose_share", "moment_max_rel")}
            | {"ms": [x["ms"] for x in r["ranks"]],
               "peak_gib": [x["peak_gib"] for x in r["ranks"]]}
            for run, r in report["steps"]["TP2"]["runs"].items()}
        | {"runner_s": report["steps"]["TP2"]["runner"]["runner_s"],
           "runner_rows_rel": report["steps"]["TP2"]["runner"]["rows_rel"]}}))
    log(card)
    entries = kernel_entries(attn_rows, mlp_rows, fam_rows, ln_rows, hm_rows,
                             launches)
    for e in entries:  # the data-fed, runner and DP phases' counts
        e["pd64_launches"] = launches["PD64"][e["name"]]
        for phase in ("CLI64", "FT64", "RET", "DP1", "TP2", "AO", "TOME"):
            e[f"{phase.lower()}_launches"] = launches[phase].get(e["name"], 0)
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


CLI_STEPS = 8          # --max_steps_per_epoch
CLI_TRAIN_BATCHES = 10  # the train index: 640 clips, two batches spare
CLI_VAL_CLIPS = 128     # the --data-val index
CLI_TOL = 1e-5          # resumed against straight, as graphed against eager


def recipe_argv(recipe="pretrain_audioset.sh", runner="pretrain", **paths):
    """The argument words of ``recipes/<recipe>``'s command line (``python
    -m avsiam_tpu.cli.<runner> ...``), word for word, its variables
    (DATA_TRAIN, DATA_VAL, LABEL_CSV, EXP_DIR, ...) replaced by
    ``paths``."""
    import re
    import shlex
    from pathlib import Path
    text = (Path(__file__).resolve().parent / "recipes" / recipe).read_text()
    cmd = text[text.index(f"python -m avsiam_tpu.cli.{runner}"):]
    words = shlex.split(cmd.replace("\\\n", " "))[3:]
    return [re.sub(r"\$(\w+)", lambda m: paths[m.group(1)], w)
            for w in words if w != "$@"]


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|: 0 for the same values."""
    got, want = got.detach().float(), want.detach().float()
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) / scale


def state_diffs(got, want) -> dict:
    """``max_rel`` of each parameter and of both Adams' moments and step
    counts of two pretrain states, by name."""
    diffs = {name: max_rel(pg, pw) for (name, pw), pg in zip(
        want.model.named_parameters(), got.model.parameters(), strict=True)}
    names = {id(p): n for n, p in want.model.named_parameters()}
    for which, ow, og in (("adam1", want.opt1, got.opt1),
                          ("adam2", want.opt2, got.opt2)):
        if len(ow.state) != len(og.state):
            raise AssertionError(f"{which}: {len(og.state)} moments against "
                                 f"{len(ow.state)}")
        for (pw, stw), (_, stg) in zip(ow.state.items(), og.state.items()):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                diffs[f"{which} {key} {names[id(pw)]}"] = max_rel(stg[key],
                                                                  stw[key])
    return diffs


def cli_paths(tmp, val_clips: int = CLI_VAL_CLIPS) -> dict:
    """CLI64's data under the directory ``tmp``: a 640-clip train and a
    ``val_clips``-clip validation index of 'synthetic' clips over 527 classes and
    their label CSV, as the recipe's variables (DATA_TRAIN, DATA_VAL,
    LABEL_CSV)."""
    def index(name, n):
        path = tmp / name
        path.write_text(json.dumps({"data": [
            {"wav": f"synthetic/{name}/{i}.wav", "labels": f"/m/{i % 527}"}
            for i in range(n)]}))
        return str(path)

    labels = tmp / "labels.csv"
    labels.write_text("index,mid,display_name\n" + "".join(
        f"{i},/m/{i},class {i}\n" for i in range(527)))
    return dict(DATA_TRAIN=index("train.json", 64 * CLI_TRAIN_BATCHES),
                DATA_VAL=index("val.json", val_clips),
                LABEL_CSV=str(labels))


def cli_argv(paths, exp_dir, *extra, steps: int = CLI_STEPS):
    """The pretrain recipe's words over ``paths`` into ``exp_dir``, with
    'synthetic' frames, ``steps`` steps an epoch and ``extra``."""
    return recipe_argv(**paths, EXP_DIR=str(exp_dir)) + [
        "--frame_source", "synthetic", "--max_steps_per_epoch",
        str(steps), *extra]


def digests(tensors) -> dict:
    """{name: blake2b of the tensor's bytes}: two equal digests mean the
    same bits."""
    import hashlib
    return {name: hashlib.blake2b(
        t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
        .tobytes(), digest_size=16).hexdigest() for name, t in tensors}


def state_tensors(state, moments: bool = True):
    """(name, tensor) of every parameter and, with ``moments``, of each
    Adam's moments and step counts of a pretrain state."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    yield from state.model.named_parameters()
    if moments:
        for which, opt in state.optimizers().items():
            for p, st in opt.state.items():
                for k in ("exp_avg", "exp_avg_sq", "step"):
                    yield f"{which} {k} {names[id(p)]}", st[k]


def same_bits(label, got: dict, want: dict) -> int:
    """The number of equal digests; raises unless every one is."""
    diff = sorted(k for k in want if got.get(k) != want[k])
    if got.keys() != want.keys() or diff:
        raise AssertionError(f"{label}: {len(diff)} of {len(want)} tensors "
                             f"differ (first: {diff[:3]}), names equal "
                             f"{got.keys() == want.keys()}")
    return len(want)


def run_cli(label, seed, report, keep_params=None, reference=None):
    """Phase CLI64: the port's runner, ``avsiam_tpu_torch.cli.pretrain.main``,
    on the AudioSet pretrain recipe's command line word for word
    (``recipes/pretrain_audioset.sh``: ViT-B, B=64, lr 2e-4, mask 0.25,
    contrast 1 and MAE 0, noise, target length 1024, 'exact', bf16), on the
    card through the graphed step. Only these differ: ``--frame_source
    synthetic`` over an index of 'synthetic' clips, ``--max_steps_per_epoch
    8``, ``--data-val`` a 128-clip index, ``--n-epochs`` 1 or 2; index,
    labels and experiment directories are written under
    ``build/chip_smoke_cli`` and removed at the end.

    Three runs: (a) epoch 1, fresh; (b) ``--resume`` in (a)'s directory to
    epoch 2; (c) epochs 1-2 straight with ``--save_model False``. Each must
    write finite losses in every ``result.csv`` row and launch each kernel
    as often as its steps and validation batches imply (the recipe's
    per-step counts, and one contrastive forward's per eval batch), counted
    from 0 just before the run. (b) against (c): every parameter, both
    Adams' moments and step counts, and each epoch's row within ``CLI_TOL``
    relative (the same bits are expected); after (b)'s restore both Adams
    read one lr tensor. ``best_audio_model`` equals the best epoch's
    ``audio_model``, and ``train_state.2`` restores into a fresh state as
    (b) left it, bit for bit. Printed per run: steps, clips/s from the
    loop's ``per_sample_time`` meter, the data share from
    ``per_sample_data_time``, ms per validation batch, seconds per
    checkpoint save and per restore, and the peak allocated GiB. With
    ``keep_params`` (a path) (b)'s ``best_audio_model`` is copied there
    before the directories go; with ``reference`` (a dict) (a)'s
    ``result.csv`` rows and its parameters' digests are kept there (for
    DP1)."""
    import csv
    import gc
    import shutil
    import tempfile
    from pathlib import Path

    from avsiam_tpu_torch import kernels
    from avsiam_tpu_torch.cli import pretrain as cli
    from avsiam_tpu_torch.configs import PretrainConfig
    from avsiam_tpu_torch.train.pretrain import init_state
    from avsiam_tpu_torch.utils import checkpoint as ck
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=root))
    log(f"phase {label}: python -m avsiam_tpu_torch.cli.pretrain on the "
        f"pretrain recipe's flags, {CLI_STEPS} steps an epoch, "
        f"{CLI_VAL_CLIPS} validation clips, under {tmp}")

    paths = cli_paths(tmp)
    expect = {}
    runs = {}
    total = {}

    def run(what, exp, *extra):
        argv = cli_argv(paths, tmp / exp, *extra)
        os.environ.pop("AVSIAM_PLATFORM", None)  # the card
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.time()
        out = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not expect:  # the recipe's configuration, as the runner built it
            cfg = PretrainConfig(model=out["state"].model.cfg, batch_size=64)
            expect["step"] = expected_launches(
                cfg, main_path_shapes(cfg, 64), False, False, 1)
            expect["eval"] = forward_launches(
                cfg, main_path_shapes(cfg, 64, mae=False))
            expect["cfg"] = cfg
        with open(tmp / exp / "result.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        for r in rows:
            bad = {k: v for k, v in r.items() if k.startswith(("loss",
                   "eval_loss")) and v and not math.isfinite(float(v))}
            if bad:
                raise AssertionError(f"{label} {what}: non-finite losses in "
                                     f"result.csv row {r['epoch']}: {bad}")
        epochs = out["timing"]["epochs"]
        steps = sum(e["steps"] for e in epochs)
        evals = sum(e["eval_batches"] for e in epochs)
        want = {k: steps * n + evals * expect["eval"][k]
                for k, n in expect["step"].items()}
        if launches != want:
            raise AssertionError(f"{label} {what}: launches {launches} != "
                                 f"{want} ({steps} steps, {evals} eval "
                                 f"batches)")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        restore = out["timing"]["restore_s"]
        log(f"  {label} {what}: {wall:.1f} s, peak {peak:.2f} GiB "
            f"allocated" + ("" if restore is None else
                             f", restore {restore:.2f} s") + "; launches "
            + ", ".join(f"{k} {n}" for k, n in launches.items() if n)
            + " as expected")
        for e in epochs:
            pst, dst = e["per_sample_time"], e["per_sample_data_time"]
            log(f"    epoch {e['epoch']}: {e['steps']} steps, "
                f"{1 / pst:.1f} clips/s (per_sample_time {1e3 * pst:.2f} "
                f"ms), data share {100 * dst / pst:.1f}%; validation "
                + (f"{1e3 * e['eval_s'] / e['eval_batches']:.1f} ms a batch "
                   f"x{e['eval_batches']}" if e["eval_batches"] else "none")
                + "; saves " + ", ".join(f"{n} {t:.2f} s"
                                         for n, t in e["saves"].items()))
        runs[what] = dict(wall_s=wall, peak_gib=peak, restore_s=restore,
                          launches=launches, epochs=epochs, rows=rows,
                          best_epoch=out["best_epoch"])
        return out

    try:
        a = run("a", "a", "--n-epochs", "1")
        if reference is not None:
            reference.update(rows=runs["a"]["rows"], params=digests(
                a["model"].named_parameters()))
        del a
        b = run("b", "a", "--n-epochs", "2", "--resume")
        state_b = b["state"]
        lr = state_b.lr
        if not all(g["lr"] is lr for opt in (state_b.opt1, state_b.opt2)
                   for g in opt.param_groups):
            raise AssertionError(f"{label}: after (b)'s restore the Adams "
                                 f"read more than one lr tensor")
        del b
        c = run("c", "c", "--n-epochs", "2", "--save_model", "False")
        errs = state_diffs(state_b, c["state"])
        equal = sum(d == 0.0 for d in errs.values())
        row_err = max(abs(float(rb[k]) - float(rc[k]))
                      / max(abs(float(rc[k])), 1e-30)
                      for rb, rc in zip(runs["b"]["rows"], runs["c"]["rows"],
                                        strict=True)
                      for k in rc if k != "epoch")
        worst = max(errs, key=errs.get)
        log(f"  {label} resumed (b) against straight (c): {len(errs)} "
            f"tensors, {equal} equal bit for bit, max rel {errs[worst]:.2e} "
            f"({worst}); rows max rel {row_err:.2e} (<= {CLI_TOL})")
        if errs[worst] > CLI_TOL or row_err > CLI_TOL:
            raise AssertionError(f"{label}: resumed against straight: "
                                 f"{errs[worst]} at {worst}, rows {row_err}")
        del c
        exp_a = str(tmp / "a")
        best = runs["b"]["best_epoch"]
        saved = ck.restore_params(exp_a, "best_audio_model")
        epoch_model = ck.restore_params(exp_a, f"audio_model.{best}")
        dev = next(state_b.model.parameters()).device
        fresh = init_state(expect["cfg"], torch.Generator(
            device=dev).manual_seed(seed + 1), dev)
        ck.restore_train_state(exp_a, "train_state.2", fresh)
        same = (saved.keys() == epoch_model.keys()
                and all(torch.equal(saved[k], epoch_model[k]) for k in saved)
                and not any(state_diffs(fresh, state_b).values())
                and fresh.opt1.param_groups[0]["lr"]
                is fresh.opt2.param_groups[0]["lr"])
        listing = {d: sorted(os.listdir(tmp / d / "models")) for d in "ac"}
        log(f"  {label} checkpoints: {listing}; best_audio_model (epoch "
            f"{best}) and train_state.2 load back bit for bit: {same}")
        if not same or listing != {
                "a": ["audio_model.1", "audio_model.2", "best_audio_model",
                      "train_state.2"],
                "c": ["best_audio_model", "train_state.2"]}:
            raise AssertionError(f"{label}: checkpoints {listing}, loaded "
                                 f"back {same}")
        del fresh, state_b
        if keep_params is not None:
            shutil.copyfile(tmp / "a" / "models" / "best_audio_model",
                            keep_params)
        report.setdefault("steps", {})[label] = dict(
            batch=64, runs=runs, resume_max_rel=errs[worst],
            resume_equal=equal, resume_tensors=len(errs), rows_max_rel=row_err,
            per_step=expect["step"], per_eval=expect["eval"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return total


# ------------------------------------------------------- finetune phases
FT_RECIPE = "ft_vggsound.sh"
FT_CLASSES = 309        # the VGGSound recipe's --n_class
FT_STEPS = 8            # --max_steps_per_epoch
FT_EPOCHS = 2
FT_TRAIN_BATCHES = 10   # the train index: 640 clips, two batches spare
FT_EVAL_CLIPS = 64      # the --data_val and --data_eval indices: one batch


def ft_part_shapes(cfg, batch: int, frames: int = 1):
    """The attention and MLP shapes of one finetune forward by part:
    {'a': audio trunk, 'v': video trunk over batch x frames, 'mm': the
    fusion layers over the concatenated streams} -> (attn {(b, N, H, D):
    calls}, mlp {(rows, D, H, impl): calls})."""
    from avsiam_tpu_torch.models.layers import mlp_route
    m = cfg.model
    v = m.vit
    La, Lv = v.num_audio_tokens, v.num_video_tokens
    H = v.dim * int(v.mlp_ratio)
    impl = mlp_route(m.mlp_impl, v.dim, H)
    hd = v.dim // v.num_heads
    out = {}
    for part, b, n, calls in (("a", batch, La, v.depth),
                              ("v", batch * frames, Lv, v.depth),
                              ("mm", batch * frames, La + Lv, 2)):
        out[part] = ({(b, n, v.num_heads, hd): calls},
                     {(b * n, v.dim, H, impl): calls})
    return out


FT_BRANCH_PARTS = {"av": ("a", "v", "mm"), "a": ("a",), "v": ("v",)}


def ft_launches(cfg, batch: int, frames: int = 1, branch=None) -> dict:
    """Each kernel's launches of one finetune forward (all three parts, as
    'mm_grad' runs them) and, with ``branch``, the backward of that
    branch's parts only (``expected_launches`` of them less their
    forward)."""
    parts = ft_part_shapes(cfg, batch, frames)

    def shapes(names):
        attn, mlp = {}, {}
        for p in names:
            for table, add in zip((attn, mlp), parts[p]):
                for k, c in add.items():
                    table[k] = table.get(k, 0) + c
        return Shapes(attn, mlp, {}, {}, {}, set())

    out = forward_launches(cfg, shapes(("a", "v", "mm")))
    if branch is not None:
        back = shapes(FT_BRANCH_PARTS[branch])
        full, fwd = (expected_launches(cfg, back, False, False, 1),
                     forward_launches(cfg, back))
        for k in out:
            out[k] += full[k] - fwd[k]
    return out


def run_ft_cli(label, seed, report, pretrain_path, keep_params=None):
    """Phase FT64: the port's finetune runner, ``avsiam_tpu_torch.cli.
    finetune.main``, on the VGGSound recipe's command line word for word
    (``recipes/ft_vggsound.sh``: ViT-B, 'mm_grad', CE, accuracy, B=64, 309
    classes, lr 5e-5 with head and fusion rates x10, mixup 0.5, freqm 48,
    timem 192, noise, label smoothing 0.1, bf16), on the card. Only these
    differ: ``--frame_source synthetic`` over index files of 'synthetic'
    clips labelled over 309 classes, ``--max_steps_per_epoch 8``,
    ``--n_epochs 2``, ``--data_val`` and ``--data_eval`` over 64 clips (one
    10-frame batch), ``--wa True --wa_start 1 --wa_end 2`` and
    ``--pretrain_path`` the pretrain params file ``pretrain_path``; index,
    labels and experiment directory are written under
    ``build/chip_smoke_ft`` and removed at the end.

    It must write finite losses, ``acc`` and ``mAP`` in every
    ``result.csv`` row, and launch each kernel as often as the steps'
    branches and the eval batches imply, counted from 0 just before the
    run (``ft_launches``). Printed per epoch: the steps by branch, clips/s
    from the loop's ``per_sample_time`` meter, the data share, ms per
    10-frame validation batch and seconds per save; then the averaging's
    seconds and the peak allocated GiB. With ``keep_params`` (a path) the
    run's ``best_audio_model`` is copied there before the directory goes.
    Returns the run's launch counts."""
    import csv
    import gc
    import shutil
    import tempfile
    from pathlib import Path

    from avsiam_tpu_torch import kernels
    from avsiam_tpu_torch.cli import finetune as cli
    from avsiam_tpu_torch.configs import FinetuneConfig
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_ft"
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=root))
    log(f"phase {label}: python -m avsiam_tpu_torch.cli.finetune on the "
        f"{FT_RECIPE} recipe's flags, {FT_STEPS} steps an epoch, "
        f"{FT_EPOCHS} epochs, {FT_EVAL_CLIPS} validation and eval clips of "
        f"10 frames, from {pretrain_path}, under {tmp}")

    def index(name, n):
        path = tmp / name
        path.write_text(json.dumps({"data": [
            {"wav": f"synthetic/{name}/{i}.wav",
             "labels": f"/m/{i % FT_CLASSES}"} for i in range(n)]}))
        return str(path)

    labels = tmp / "labels.csv"
    labels.write_text("index,mid,display_name\n" + "".join(
        f"{i},/m/{i},class {i}\n" for i in range(FT_CLASSES)))
    exp = tmp / "exp"
    argv = recipe_argv(
        FT_RECIPE, "finetune", DATA_TRAIN=index("train.json",
                                                64 * FT_TRAIN_BATCHES),
        DATA_VAL=index("val.json", FT_EVAL_CLIPS), LABEL_CSV=str(labels),
        PRETRAIN=str(pretrain_path), EXP_DIR=str(exp)) + [
        "--frame_source", "synthetic", "--max_steps_per_epoch",
        str(FT_STEPS), "--n_epochs", str(FT_EPOCHS), "--data_eval",
        index("eval.json", FT_EVAL_CLIPS), "--wa", "True", "--wa_start", "1",
        "--wa_end", str(FT_EPOCHS)]
    os.environ.pop("AVSIAM_PLATFORM", None)  # the card
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.time()
        out = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        state = out["state"]
        cfg = FinetuneConfig(model=state.model.cfg, batch_size=64)
        if (cfg.model.label_dim, cfg.model.vit.depth,
                cfg.model.dtype) != (FT_CLASSES, 12, torch.bfloat16):
            raise AssertionError(f"{label}: the recipe built {cfg.model}")
        with open(exp / "result.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        if [int(r["epoch"]) for r in rows] != list(range(1, FT_EPOCHS + 1)):
            raise AssertionError(f"{label}: result.csv epochs "
                                 f"{[r['epoch'] for r in rows]}")
        for r in rows:
            vals = {k: float(r[k]) for k in ("train_loss", "val_loss", "acc",
                                             "mAP", "mAUC")}
            if not all(math.isfinite(x) for x in vals.values()):
                raise AssertionError(f"{label}: non-finite values in "
                                     f"result.csv row {r['epoch']}: {vals}")
        epochs = out["timing"]["epochs"]
        evals = sum(e["eval_batches"] for e in epochs) + 1  # --data_eval
        want = ft_launches(cfg, 64, 10)
        want = {k: n * evals for k, n in want.items()}
        for branch, n in state.branches.items():
            for k, c in ft_launches(cfg, 64, branch=branch).items():
                want[k] += n * c
        if launches != want:
            raise AssertionError(f"{label}: launches {launches} != {want} "
                                 f"(branches {state.branches}, {evals} eval "
                                 f"batches)")
        log(f"  {label}: {wall:.1f} s, peak {peak:.2f} GiB allocated; "
            f"branches {state.branches}; launches "
            + ", ".join(f"{k} {n}" for k, n in launches.items() if n)
            + " as expected")
        for e, r in zip(epochs, rows):
            pst, dst = e["per_sample_time"], e["per_sample_data_time"]
            log(f"    epoch {e['epoch']}: {e['steps']} steps "
                f"{e['branches']}, {1 / pst:.1f} clips/s (per_sample_time "
                f"{1e3 * pst:.2f} ms), data share {100 * dst / pst:.1f}%; "
                f"train loss {float(r['train_loss']):.4f}, val loss "
                f"{float(r['val_loss']):.4f}, acc {float(r['acc']):.4f}, mAP "
                f"{float(r['mAP']):.4f}; validation "
                f"{1e3 * e['eval_s'] / e['eval_batches']:.1f} ms a 10-frame "
                f"batch x{e['eval_batches']}; saves " + ", ".join(
                    f"{n} {t:.2f} s" for n, t in e["saves"].items()))
        wa_s = out["timing"]["wa_s"]
        if wa_s is None or "wa_params" not in out:
            raise AssertionError(f"{label}: no checkpoint average")
        stats = out["eval_stats"]
        acc = stats[0]["acc"]
        log(f"  {label}: averaging epochs 1-{FT_EPOCHS} {wa_s:.2f} s; eval "
            f"set acc {acc:.4f}, mAP "
            f"{sum(s['AP'] for s in stats) / len(stats):.4f}")
        report.setdefault("steps", {})[label] = dict(
            batch=64, wall_s=wall, peak_gib=peak, launches=launches,
            branches=dict(state.branches), epochs=epochs, rows=rows,
            wa_s=wa_s, eval_acc=acc, best_epoch=out["best_epoch"])
        if keep_params is not None:
            shutil.copyfile(exp / "models" / "best_audio_model", keep_params)
        del out, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# ------------------------------------------------- data-parallel phase
DP1_STEPS = 3      # graphed steps held bit for bit against one process's
DP1_TIMED = 5      # more replays, timed
DP1_TIMEOUT = 420  # seconds for the launcher and its worker


def dp1_worker(out_path: str, seed: int) -> int:
    """DP1's worker, one rank under ``torch.distributed.run`` on the card
    (NCCL): (a) P64's graphed step (ViT-B, 'padded', B=64) under the
    process group, the collectives in the graph, ``DP1_STEPS`` steps from
    ``compare_eager_graphed``'s seed, state, batch and draws, then
    ``DP1_TIMED`` timed replays and one profiled; (b) the pretrain runner
    on CLI64's (a) command line. Writes the digests, metrics, rows,
    timings and launch counts to ``out_path`` as JSON."""
    import csv
    import shutil
    import tempfile
    from pathlib import Path

    from avsiam_tpu_torch import kernels
    from avsiam_tpu_torch.cli import pretrain as cli
    from avsiam_tpu_torch.configs import PretrainConfig
    from avsiam_tpu_torch.parallel import dist as pdist
    from avsiam_tpu_torch.train.pretrain import (init_state,
                                                 make_graphed_pretrain_step)
    info = pdist.initialize_multihost()
    if not (pdist.active() and torch.distributed.get_backend() == "nccl"):
        raise AssertionError(f"DP1: no NCCL process group ({info})")
    out = {"info": info}
    impls, batch = next((i, b) for label, i, _, _, _, b in PHASES
                        if label == "P64")
    cfg = phase_config(impls, depth=PHASE_DEPTH.get("P64"), batch=batch)
    per_step = expected_launches(cfg, main_path_shapes(cfg, cfg.batch_size),
                                 False, False, 1)
    kernels.library()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = init_state(cfg, gen, "cuda")
    batch = step_batch(cfg, gen)
    step = make_graphed_pretrain_step(cfg)
    kernels.reset_launches()
    metrics = []
    for i in range(DP1_STEPS):
        state, m = step(state, batch, gen, cfg.opt.lr * 0.5 ** i)
        metrics.append({k: float(x).hex() for k, x in m.items()})
    torch.cuda.synchronize()
    out.update(metrics=metrics, state=digests(state_tensors(state)))
    steps = timed_steps("DP1 replay", step, state, batch, gen, cfg.opt.lr,
                        DP1_TIMED, first=DP1_STEPS)
    steady = median_after_first(steps)
    prof = profile_step(step, state, batch, gen, cfg.opt.lr, steady)
    n_calls = DP1_STEPS + DP1_TIMED + 1
    launches_a = dict(kernels.LAUNCHES)
    check_launches("DP1 (a)", launches_a, per_step, n_calls)
    nccl_ms = None if prof is None else prof["groups"].get(
        "NCCL collectives", 0.0)
    nccl_calls = None if prof is None else prof["group_calls"].get(
        "NCCL collectives", 0)
    out.update(steady_ms=steady, nccl_ms=nccl_ms, nccl_calls=nccl_calls,
               busy_ms=None if prof is None else prof["busy_ms"],
               launches_a=launches_a, calls_a=n_calls)
    del step, state
    torch.cuda.empty_cache()

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_dp1"
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=root))
    try:
        kernels.reset_launches()
        t0 = time.time()
        run = cli.main(cli_argv(cli_paths(tmp), tmp / "exp", "--n-epochs",
                                "1"))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches_b = dict(kernels.LAUNCHES)
        rcfg = PretrainConfig(model=run["state"].model.cfg, batch_size=64)
        epochs = run["timing"]["epochs"]
        n_steps = sum(e["steps"] for e in epochs)
        n_evals = sum(e["eval_batches"] for e in epochs)
        step_l = expected_launches(rcfg, main_path_shapes(rcfg, 64), False,
                                   False, 1)
        eval_l = forward_launches(rcfg, main_path_shapes(rcfg, 64,
                                                         mae=False))
        want = {k: n_steps * n + n_evals * eval_l[k]
                for k, n in step_l.items()}
        if launches_b != want:
            raise AssertionError(f"DP1 (b): launches {launches_b} != {want}")
        with open(tmp / "exp" / "result.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        files = sorted(str(p.relative_to(tmp / "exp"))
                       for p in (tmp / "exp").rglob("*") if p.is_file())
        out.update(rows=rows, params=digests(
            run["model"].named_parameters()), runner_s=wall,
            launches_b=launches_b, runner_steps=n_steps,
            runner_evals=n_evals, files=files, epochs=epochs)
        del run
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    with open(out_path, "w") as f:
        json.dump(out, f, default=str)
    torch.distributed.destroy_process_group()
    return 0


def run_dp1(label, seed, report, ref_steps, ref_cli):
    """Phase DP1: ``chip_smoke.py --dp1-worker`` launched through
    ``python -m torch.distributed.run --standalone --nproc_per_node=1`` (one
    rank, NCCL; the card's host has one card, and NCCL takes one rank a
    device). (a) against ``ref_steps``, the single-process graphed P64 run
    of ``compare_eager_graphed``: every parameter, Adam moment and step
    count (digests) and every metric of the ``DP1_STEPS`` steps the same
    bits (a mean over one rank and a gather of one are exact); the steady
    replay, the NCCL kernels' device time in a profiled replay, K1-K3's
    launches. (b) against ``ref_cli``, CLI64's run (a): ``result.csv`` and
    every parameter the same bits; the files rank 0 wrote. Returns the
    worker's launch counts, (a)'s and (b)'s summed."""
    import signal
    from pathlib import Path
    root = Path(__file__).resolve().parent
    out_path = root / "build" / "chip_smoke_dp1.json"
    out_path.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", str(root / "chip_smoke.py"), "--dp1-worker",
           str(out_path), "--seed", str(seed)]
    log(f"phase {label}: {' '.join(cmd[1:])}: (a) P64's graphed step with "
        f"its collectives over one NCCL rank, {DP1_STEPS} steps against the "
        f"single-process graphed run, {DP1_TIMED} replays timed; (b) the "
        f"pretrain runner on CLI64 (a)'s command line")
    env = dict(os.environ)
    env.pop("AVSIAM_PLATFORM", None)
    # torchrun would set 1 thread where the variable is unset
    env.setdefault("OMP_NUM_THREADS", str(torch.get_num_threads()))
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=DP1_TIMEOUT)
    finally:
        if proc.poll() is None:  # the launcher and its worker, on timeout
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    wall = time.time() - t0
    for line in text.splitlines():
        if line.startswith(("  ", "phase", "Epoch", "Eval", "mesh", "pretrain",
                            "resumed")):
            log(f"  | {line}")
    if proc.returncode != 0:
        raise AssertionError(f"{label}: the worker exited "
                             f"{proc.returncode}:\n{text[-6000:]}")
    with open(out_path) as f:
        got = json.load(f)
    n_state = same_bits(f"{label} (a) state", got["state"], ref_steps["state"])
    if got["metrics"] != ref_steps["metrics"]:
        raise AssertionError(f"{label} (a): metrics {got['metrics']} != "
                             f"{ref_steps['metrics']}")
    n_params = same_bits(f"{label} (b) params", got["params"],
                         ref_cli["params"])
    if got["rows"] != ref_cli["rows"]:
        raise AssertionError(f"{label} (b): result.csv {got['rows']} != "
                             f"{ref_cli['rows']}")
    launches = {k: got["launches_a"][k] + got["launches_b"][k]
                for k in got["launches_a"]}
    nccl = got["nccl_ms"]
    log(f"  {label} (a): {n_state} tensors and "
        f"{DP1_STEPS * len(got['metrics'][0])} metrics equal bit for bit to "
        f"the single-process graphed step; steady replay "
        f"{got['steady_ms']:.1f} ms, NCCL kernels "
        + ("not measured" if nccl is None else
           f"{got['nccl_calls']} calls, {nccl:.2f} ms")
        + " of device time a step; launches "
        + ", ".join(f"{k} {n}" for k, n in got["launches_a"].items() if n)
        + f" as expected ({got['calls_a']} calls)")
    log(f"  {label} (b): {got['runner_steps']} steps, {got['runner_evals']} "
        f"validation batches in {got['runner_s']:.1f} s; result.csv and "
        f"{n_params} parameters equal bit for bit to CLI64 (a); rank 0 "
        f"wrote {got['files']}; launches "
        + ", ".join(f"{k} {n}" for k, n in got["launches_b"].items() if n)
        + " as expected")
    log(f"  {label}: {wall:.1f} s with the launcher")
    report.setdefault("steps", {})[label] = dict(
        batch=64, wall_s=wall, graphed_steady_ms=got["steady_ms"],
        nccl_ms=nccl, nccl_calls=got["nccl_calls"], busy_ms=got["busy_ms"],
        state_tensors=n_state,
        runner_s=got["runner_s"], params_equal=n_params,
        launches=launches, files=got["files"], epochs=got["epochs"])
    return launches


# ------------------------------------------------------ tensor parallelism
TP2_STEPS = 3       # eager steps a run, the lr halved each step
TP2_H_DEPTH = 4     # TP2-H's encoder depth (of ViT-H's 32), for the time
TP2_RUNS = (("TP2-H", dict(model="cav-mae-huge", attn_impl="pallas",
                           mlp_impl="fused"), TP2_H_DEPTH),
            ("TP2-B", dict(mlp_impl="lnfres"), None))
TP2_TIMEOUT = 900   # seconds for the launcher and its workers
TP2_CLI_STEPS = 2   # the runner's --max_steps_per_epoch (CLI64's 8), for
TP2_CLI_VAL = 64    # the time, and its --data-val clips: one batch (128)
# the faults ``--tp2-fault`` plants in TP2's workers to read what the
# tolerances below catch: 'row-sum' drops the model-group sum of the video
# encoder's last attention projection (each rank adds its partial product
# and the bias alone); 'qkv-contiguous' cuts every qkv weight and bias in
# halves of the output rows instead of by heads (rank 0 all of q and half
# of k); 'none' plants nothing (the control of the same invocation)
TP2_FAULTS = ("none", "row-sum", "qkv-contiguous")
# the two-rank bf16 step against one process's: their float32 partial
# sums meet in another order, every bf16 rounding downstream may then fall
# the other way, and Adam (about lr * g / (|g| + eps) an element a pass)
# turns a flipped sign of a small gradient into a step the other way, so
# the bits differ. Held: the metrics within TP2_METRIC_TOL relative (an
# accuracy within TP2_ACC_TOL: at B=8 one sample's argmax in one of the
# two directions moves c_acc by 1/16); each Adam moment's largest
# difference, over its tensor's largest value, at most TP2_MOMENT_TOL,
# and the median of those over the tensors at most TP2_MOMENT_MEDIAN; at
# most TP2_LOOSE of the parameters' elements more than 0.1 lr a step
# apart; the replicated parameters the same bits on both ranks. Each
# limit lies between the sound runs' readings and those of the faults
# that ``--tp2-fault`` plants (the accuracy's but for 'row-sum', which
# moves no argmax: c_acc 0 apart there, 0.19 under 'qkv-contiguous'),
# read on an H100 80GB HBM3 at 700 W over three steps (TP2-H at encoder
# depth 4 / TP2-B):
#   sound:          metrics 8.6e-4 / 2.4e-3, moments 0.045 / 0.132 at most
#                   and 0.013 / 0.019 in the median, 3.0% / 4.6% loose
#   row-sum:        1.3e-2 / 2.6e-2, 1.10 / 0.59, 0.25 / 0.17, 47% / 38%,
#                   105 of 285 / 181 of 509 replicated parameters differ
#   qkv-contiguous: 5.0e-2 / 7.7e-2, 3.5 / 8.1, 1.1 / 1.4, 89% / 90%
TP2_METRIC_TOL = 5e-3
TP2_ACC_TOL = 0.07
TP2_MOMENT_TOL = 0.3
TP2_MOMENT_MEDIAN = 5e-2
TP2_LOOSE = 0.10


def tp2_state(state) -> dict:
    """{name: float32 CPU tensor} of a pretrain state's parameters and each
    Adam's moments, whole (gathered over the model group, a collective,
    where the model holds shards)."""
    from avsiam_tpu_torch.parallel.tp import (full_optimizer_state,
                                              full_state_dict, param_names)
    names = {n for n, _ in state.model.named_parameters()}
    out = {f"param {n}": t.float().cpu()
           for n, t in full_state_dict(state.model).items() if n in names}
    for which, opt in state.optimizers().items():
        order = param_names(opt, state.model)
        for i, st in full_optimizer_state(opt, state.model)["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                out[f"{which} {k} {order[i]}"] = st[k].float().cpu()
    return out


def tp2_compare(got: dict, want: dict, lr_sum: float) -> dict:
    """The gathered two-rank state against the one-process state
    (``tp2_state``'s): the largest differences (the parameters' in units
    of ``lr_sum``, the lr summed over the steps), the share of parameter
    elements more than 0.1 lr a step apart, and the moments farthest
    apart."""
    if got.keys() != want.keys():
        raise AssertionError("TP2: the states hold other tensors")
    moments, param, loose, total = {}, 0.0, 0, 0
    for k, w in want.items():
        g = got[k]
        if k.startswith("param "):
            d = (g - w).abs()
            param = max(param, float(d.max()) / lr_sum)
            loose += int((d > 0.1 * lr_sum / TP2_STEPS).sum())
            total += d.numel()
        else:
            moments[k] = max_rel(g, w)
    worst = sorted(moments, key=moments.get, reverse=True)[:3]
    return dict(param_max_over_lr=param, loose_share=loose / total,
                moment_max_rel=moments[worst[0]],
                moment_median_rel=sorted(moments.values())[len(moments) // 2],
                worst_moments={k: moments[k] for k in worst})


def tp2_breaches(r: dict) -> list:
    """The ``TP2_*`` limits that a run's readings (``tp2_worker``'s) pass:
    [] where the two-rank run holds to the one-process run."""
    limits = (("metric_rel", TP2_METRIC_TOL), ("acc_diff", TP2_ACC_TOL),
              ("moment_max_rel", TP2_MOMENT_TOL),
              ("moment_median_rel", TP2_MOMENT_MEDIAN),
              ("loose_share", TP2_LOOSE))
    out = [f"{k} {r[k]:.3e} > {lim}" for k, lim in limits if r[k] > lim]
    if r["replicated_differ"]:
        out.append(f"{r['replicated_differ']} of {r['replicated']} "
                   f"replicated parameters differ between the ranks")
    return out


def tp2_reference(label, cfg, seed: int) -> dict:
    """TP2's single-process run of ``cfg``: ``TP2_STEPS`` eager steps from
    the seed (the state, the batch and the draws from one generator, the
    lr halved each step), as the two-rank run takes them. Returns the
    metrics, the eager ms, the peak GiB and the state (``tp2_state``)."""
    from avsiam_tpu_torch.train.pretrain import init_state, make_pretrain_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = init_state(cfg, gen, "cuda")
    batch = step_batch(cfg, gen)
    step = make_pretrain_step(cfg)
    steps = [timed_steps(f"{label} one process", step, state, batch, gen,
                         cfg.opt.lr * 0.5 ** i, 1, first=i)[0]
             for i in range(TP2_STEPS)]
    out = dict(metrics=[{k: v for k, v in s.items() if k != "ms"}
                        for s in steps], ms=[s["ms"] for s in steps],
               peak_gib=memory_gib()[0], state=tp2_state(state))
    del state, step, batch
    torch.cuda.empty_cache()
    return out


def check_partial_forms(label, shapes: Shapes, gen) -> dict:
    """The MLP kernels' tensor-parallel forms at one rank's shapes against
    their plain versions: K3's and K4's fc2 pass writing the float32
    partial product without b2 and without the residual, and K7's dx pass
    writing the float32 partial dx (``ops/mlp.py``). Untimed."""
    from avsiam_tpu_torch.ops import mlp as pm
    errs = {}
    for t, d, h, impl in shapes.mlp:
        o = mlp_operands(gen, t, d, h)
        x, w1, b1, w2, do = (o[k] for k in ("x", "w1", "b1", "w2", "do"))
        f = {k: val.float() for k, val in o.items()}
        got, want = [], []
        if impl == "lnfres":
            g = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
            bl = 0.1 * torch.randn(d, generator=gen, device="cuda")
            got += pm.ln_mlp_fwd_kernel(x, g, bl, w1, b1, w2, None, 1e-5,
                                        partial=True)
            want += pm.ln_mlp_reference(f["x"], g, bl, f["w1"], b1, f["w2"],
                                        None, 1e-5, partial=True)
        if impl in ("fused", "fres"):
            got += pm.mlp_fwd_kernel(x, w1, b1, w2, None, True)
            want += pm.mlp_fwd_reference(f["x"], f["w1"], b1, f["w2"], None,
                                         save_hpre=True)
        if impl == "fused":
            got += pm.mlp_bwd_kernel(x, w1, b1, w2, do,
                                     dx_dtype=torch.float32)
            want += pm.mlp_bwd_reference(f["x"], f["w1"], b1, f["w2"],
                                         f["do"], dx_dtype=torch.float32)
        if not got:
            continue
        if got[0].dtype != torch.float32:
            raise AssertionError(f"{label}: the partial product is "
                                 f"{got[0].dtype}, not float32")
        name = f"{impl} partial T={t} D={d} H={h}"
        errs[name] = max(rel_err(g_, w_)[1] for g_, w_ in zip(got, want))
        del got, want
    for name, e in errs.items():
        log(f"  {label} shape {name}: rel err {e:.1e} (<= {MLP_TOL})")
        if e > MLP_TOL:
            raise AssertionError(f"{label} {name}: rel err {e:.3e} > "
                                 f"{MLP_TOL}")
    return errs


def plant_tp2_fault(model, fault: str) -> None:
    """Plant ``fault`` (``TP2_FAULTS``) in this rank's sharded ``model``,
    in place: a check of what TP2's tolerances catch, never part of a
    sound run."""
    from avsiam_tpu_torch.parallel import dist as pdist
    from avsiam_tpu_torch.parallel.tp import full_state_dict
    if fault == "row-sum":
        depth = len(model.vit.blocks)
        model.get_submodule(f"vit.blocks.{depth - 1}.attn.proj").parallel = \
            None
    elif fault == "qkv-contiguous":
        full = full_state_dict(model)  # collective
        r, m = pdist.model_rank(), pdist.model_size()
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n.endswith(("qkv.weight", "qkv.bias")):
                    p.data = full[n].chunk(m, dim=0)[r].clone()
    elif fault != "none":
        raise ValueError(f"no fault {fault!r} in {TP2_FAULTS}")


def tp2_worker(out_path: str, seed: int, fault=None) -> int:
    """TP2's worker, one of two ranks under ``torch.distributed.run`` on
    one card (a mesh of data 1 x model 2; gloo, which ``initialize_
    multihost`` takes where the host has fewer cards than ranks). Per run
    of ``TP2_RUNS``: ``TP2_STEPS`` eager steps from the seed at full width
    (the model cut to the rank's shards), each rank's launches and peak
    memory, the replicated parameters' digests, one more step profiled on
    rank 0 (``profile_step``), and on rank 0 the gathered
    state against ``tp2_reference``'s (written by the parent), each kernel
    against its plain version at the rank's shapes (``check_at_shapes``)
    and the partial forms (``check_partial_forms``). Then the pretrain
    runner on the command line that the parent ran in one process into
    ``build/chip_smoke_tp2/cli``, with ``--mesh_model 2``: its rows,
    launches, the gathered final parameters' digests. With ``fault``
    (``TP2_FAULTS``) planted after the init, only the steps and their
    readings, which are recorded and not held to the limits. Rank 0 writes
    the JSON to ``out_path``."""
    import csv
    from pathlib import Path

    import torch.distributed as tdist

    from avsiam_tpu_torch import kernels
    from avsiam_tpu_torch.cli import pretrain as cli
    from avsiam_tpu_torch.configs import MeshConfig, PretrainConfig
    from avsiam_tpu_torch.parallel import dist as pdist
    from avsiam_tpu_torch.parallel.mesh import make_mesh, split_dim
    from avsiam_tpu_torch.parallel.tp import full_state_dict
    from avsiam_tpu_torch.train.pretrain import init_state, make_pretrain_step
    info = pdist.initialize_multihost()
    main = pdist.rank() == 0
    say = log if main else (lambda msg: None)
    say(f"backend {pdist.backend()}: {info['process_count']} ranks on "
        f"{torch.cuda.device_count()} card(s)")
    if info["process_count"] != 2 or pdist.backend() != "gloo":
        raise AssertionError(f"TP2: no two-rank gloo group ({info})")
    kernels.library()
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_tp2"
    out = {"info": info, "runs": {}}
    for label, impls, depth in TP2_RUNS:
        cfg = phase_config(impls, depth=depth, batch=8)
        mesh = make_mesh(MeshConfig(model=2), cfg.model)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        state = init_state(cfg, gen, "cuda")
        if fault:
            plant_tp2_fault(state.model, fault)
        batch = step_batch(cfg, gen)
        step = make_pretrain_step(cfg)
        kernels.reset_launches()
        steps = [timed_steps(f"{label} rank {pdist.rank()}", step, state,
                             batch, gen, cfg.opt.lr * 0.5 ** i, 1, first=i)[0]
                 for i in range(TP2_STEPS)]
        launches = dict(kernels.LAUNCHES)
        peak = memory_gib()[0]
        replicated = digests((n, p) for n, p in state.model.named_parameters()
                             if split_dim(n) is None)
        ranks = [None, None]
        tdist.all_gather_object(ranks, dict(
            launches=launches, peak_gib=peak, ms=[s["ms"] for s in steps],
            replicated=replicated))
        got = tp2_state(state)  # collective
        # one more step, profiled on rank 0: each kernel's device time at
        # the rank's shapes, and the host copies of gloo's sums
        lr = cfg.opt.lr * 0.5 ** TP2_STEPS
        steady = sorted(s["ms"] for s in steps)[TP2_STEPS // 2]
        prof = None
        if main and not fault:
            prof = profile_step(step, state, batch, gen, lr, steady)
        elif not fault:
            step(state, batch, gen, lr)
            torch.cuda.synchronize()
        del state, step, batch
        torch.cuda.empty_cache()
        if main:
            ref = torch.load(root / f"{label}.pt", weights_only=True)
            per_step = expected_launches(
                cfg, main_path_shapes(cfg, cfg.batch_size), False, False, 1)
            for r, got_r in enumerate(ranks):
                check_launches(f"{label} rank {r}", got_r["launches"],
                               per_step, TP2_STEPS)
            a, b = ranks[0]["replicated"], ranks[1]["replicated"]
            metrics = [{k: v for k, v in s.items() if k != "ms"}
                       for s in steps]
            lr_sum = sum(cfg.opt.lr * 0.5 ** i for i in range(TP2_STEPS))
            r = dict(
                ranks=ranks, metrics=metrics,
                metric_rel=max(abs(gs[k] - ws[k]) / max(abs(ws[k]), 1e-30)
                               for gs, ws in zip(metrics, ref["metrics"])
                               for k in ws if k != "c_acc"),
                acc_diff=max(abs(gs["c_acc"] - ws["c_acc"])
                             for gs, ws in zip(metrics, ref["metrics"])),
                replicated=len(a), replicated_differ=sum(
                    b.get(k) != v for k, v in a.items()),
                tensors=len(got), depth=cfg.model.vit.depth,
                **tp2_compare(got, ref["state"], lr_sum))
            r["breaches"] = tp2_breaches(r)
            if r["breaches"] and not fault:
                raise AssertionError(f"{label}: the two-rank run beyond "
                                     f"tolerance: {r['breaches']}; metrics "
                                     f"{metrics} against one process's "
                                     f"{ref['metrics']}")
            if not fault:
                local = main_path_shapes(cfg, cfg.batch_size,
                                         model=mesh.model)
                r["kernel_errs"] = check_at_shapes(label, cfg, local, gen)
                r["kernel_errs"].update(check_partial_forms(label, local,
                                                            gen))
                r["profile"] = None if prof is None else {
                    k: prof[k] for k in ("busy_ms", "steady_ms", "kernels",
                                         "groups", "group_calls")}
            out["runs"][label] = r
        del got
        tdist.barrier()

    if not fault:
        # the runner, on the command line the parent ran in one process
        cli_dir = root / "cli"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.time()
        run = cli.main(tp2_cli_argv(cli_dir, "exp", "--mesh_model", "2"))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(kernels.LAUNCHES)
        names = {n for n, _ in run["model"].named_parameters()}
        final = digests((n, t) for n, t in full_state_dict(  # collective
            run["model"]).items() if n in names)
        if main:
            rcfg = PretrainConfig(model=run["state"].model.cfg, batch_size=64)
            epochs = run["timing"]["epochs"]
            n_steps = sum(e["steps"] for e in epochs)
            n_evals = sum(e["eval_batches"] for e in epochs)
            step_l = expected_launches(rcfg, main_path_shapes(rcfg, 64),
                                       False, False, 1)
            eval_l = forward_launches(rcfg, main_path_shapes(rcfg, 64,
                                                             mae=False))
            want = {k: n_steps * n + n_evals * eval_l[k]
                    for k, n in step_l.items()}
            if launches != want:
                raise AssertionError(f"TP2 runner: launches {launches} != "
                                     f"{want}")
            with open(cli_dir / "exp" / "result.csv", newline="") as f:
                rows = list(csv.DictReader(f))
            out["cli"] = dict(rows=rows, params=final, runner_s=wall,
                              launches=launches, steps=n_steps,
                              evals=n_evals, peak_gib=memory_gib()[0],
                              epochs=epochs)
        del run
    if main:
        with open(out_path, "w") as f:
            json.dump(out, f, default=str)
    tdist.barrier()
    tdist.destroy_process_group()
    return 0


def tp2_cli_argv(cli_dir, exp: str, *extra):
    """TP2's runner command line: CLI64 (a)'s with ``TP2_CLI_STEPS`` steps
    and the ``TP2_CLI_VAL``-clip validation index under ``cli_dir``, one
    epoch, into ``cli_dir / exp``."""
    paths = dict(DATA_TRAIN=str(cli_dir / "train.json"),
                 DATA_VAL=str(cli_dir / "val.json"),
                 LABEL_CSV=str(cli_dir / "labels.csv"))
    return cli_argv(paths, cli_dir / exp, "--n-epochs", "1", *extra,
                    steps=TP2_CLI_STEPS)


def tp2_log_run(run, r, ref):
    """Print one TP2 run's readings (``tp2_worker``'s) beside the
    one-process run's."""
    log(f"  {run} (encoder depth {r['depth']}): eager step "
        + ", ".join(f"rank {i} " + " ".join(f"{ms:.0f}" for ms in x["ms"])
                    + " ms" for i, x in enumerate(r["ranks"]))
        + " (one process " + " ".join(f"{ms:.0f}" for ms in ref["ms"])
        + " ms); peak " + ", ".join(
            f"rank {i} {x['peak_gib']:.1f}" for i, x in enumerate(r["ranks"]))
        + f" GiB (one process {ref['peak_gib']:.1f})")
    log(f"  {run}: metrics within {r['metric_rel']:.2e} relative of one "
        f"process's (<= {TP2_METRIC_TOL}), c_acc within {r['acc_diff']:.4f} "
        f"(<= {TP2_ACC_TOL}); {r['tensors']} gathered tensors: parameters "
        f"within {r['param_max_over_lr']:.2f} lr summed over the steps, "
        f"{100 * r['loose_share']:.3f}% beyond 0.1 lr a step (<= "
        f"{100 * TP2_LOOSE:g}%), moments within {r['moment_max_rel']:.2e} of "
        f"scale (<= {TP2_MOMENT_TOL}; median {r['moment_median_rel']:.2e} <= "
        f"{TP2_MOMENT_MEDIAN}; farthest " + ", ".join(
            f"{k} {v:.2e}" for k, v in r["worst_moments"].items()) + "); "
        f"{r['replicated'] - r['replicated_differ']} of {r['replicated']} "
        f"replicated parameters the same bits on both ranks; launches a "
        f"rank " + ", ".join(f"{k} {n}" for k, n in
                             r["ranks"][0]["launches"].items() if n)
        + " as one process's")


def run_tp2(label, seed, report, fault=None):
    """Phase TP2: tensor parallelism over two ranks on the one card. For
    each run of ``TP2_RUNS`` (TP2-H: ViT-H at encoder depth
    ``TP2_H_DEPTH``, 'pallas' attention and 'fused' MLP, phase E's impls;
    TP2-B: ViT-B, phase A's), ``tp2_reference`` here, in one process;
    then the pretrain runner here on CLI64 (a)'s command line cut to
    ``TP2_CLI_STEPS`` steps and one validation batch (``tp2_cli_argv``);
    then ``chip_smoke.py --tp2-worker`` under ``python -m
    torch.distributed.run --standalone --nproc_per_node=2``
    (``tp2_worker``): the two-rank eager steps against the one-process
    ones (metrics, the gathered parameters and Adam moments within the
    ``TP2_*`` tolerances, the replicated parameters the same bits on both
    ranks), each rank's launches as one process's, each kernel against its
    plain version at a rank's shapes; then the runner's command line with
    ``--mesh_model 2``: ``result.csv`` against the one-process run's
    within ``TP2_METRIC_TOL``, and its ``train_state.1`` and
    ``best_audio_model`` loaded here by one process, the parameters the
    same bits as the run's gathered ones. Returns the workers' launches
    (rank 0's, both runs and the runner summed).

    With ``fault`` (``TP2_FAULTS``, ``--tp2-fault``) the workers plant it
    and take only the steps: the readings are printed, and the phase
    raises where a planted fault passes every limit (or 'none' breaks
    one)."""
    import csv
    import shutil
    import signal
    from pathlib import Path

    from avsiam_tpu_torch.cli import pretrain as cli
    from avsiam_tpu_torch.configs import PretrainConfig
    from avsiam_tpu_torch.models.variants import pretrain_config
    from avsiam_tpu_torch.train.pretrain import init_state
    from avsiam_tpu_torch.utils import checkpoint as ck
    root = Path(__file__).resolve().parent
    tp_dir = root / "build" / "chip_smoke_tp2"
    shutil.rmtree(tp_dir, ignore_errors=True)
    tp_dir.mkdir(parents=True)
    log(f"phase {label}: tensor parallelism, data 1 x model 2 ranks on one "
        f"card; runs " + ", ".join(
            f"{run} (encoder depth "
            f"{phase_config(i, depth=d).model.vit.depth})"
            for run, i, d in TP2_RUNS)
        + ("" if fault is None else f"; planted fault {fault!r}, the steps "
           "only"))
    refs = {}
    t0 = time.time()
    try:
        for run, impls, depth in TP2_RUNS:
            cfg = phase_config(impls, depth=depth, batch=8)
            refs[run] = tp2_reference(run, cfg, seed)
            torch.save({"metrics": refs[run]["metrics"],
                        "state": refs[run].pop("state")}, tp_dir / f"{run}.pt")
        torch.cuda.empty_cache()
        cli_dir = tp_dir / "cli"
        if fault is None:
            cli_dir.mkdir()
            cli_paths(cli_dir, val_clips=TP2_CLI_VAL)
            t1 = time.time()
            one = cli.main(tp2_cli_argv(cli_dir, "one"))
            torch.cuda.synchronize()
            one_s = time.time() - t1
            del one
            torch.cuda.empty_cache()
            with open(cli_dir / "one" / "result.csv", newline="") as f:
                one_rows = list(csv.DictReader(f))
            log(f"  {label} runner in one process: {one_s:.1f} s")
        out_path = tp_dir / "tp2.json"
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node=2", str(root / "chip_smoke.py"),
               "--tp2-worker", str(out_path), "--seed", str(seed)]
        if fault:
            cmd += ["--tp2-fault", fault]
        log(f"  {' '.join(cmd[1:])}")
        env = dict(os.environ)
        env.pop("AVSIAM_PLATFORM", None)
        env.setdefault("OMP_NUM_THREADS", str(torch.get_num_threads()))
        t1 = time.time()
        proc = subprocess.Popen(cmd, cwd=root, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            text, _ = proc.communicate(timeout=TP2_TIMEOUT)
        finally:
            if proc.poll() is None:  # the launcher and its workers
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        workers_s = time.time() - t1
        for line in text.splitlines():
            if line.startswith(("  ", "phase", "backend", "Epoch", "Eval",
                                "mesh", "pretrain", "tensor")):
                log(f"  | {line}")
        if proc.returncode != 0:
            raise AssertionError(f"{label}: the workers exited "
                                 f"{proc.returncode}:\n{text[-6000:]}")
        with open(out_path) as f:
            got = json.load(f)
        launches = {}
        for run, r in got["runs"].items():
            tp2_log_run(run, r, refs[run])
            for k, n in r["ranks"][0]["launches"].items():
                launches[k] = launches.get(k, 0) + n
        if fault:
            caught = {run: r["breaches"] for run, r in got["runs"].items()}
            log(f"  {label} planted fault {fault!r}: limits passed by each "
                f"run: {caught}")
            if (fault == "none") == any(caught.values()):
                raise AssertionError(f"{label}: fault {fault!r}, limits "
                                     f"passed {caught}")
            report.setdefault("steps", {})[label] = dict(
                fault=fault, runs=got["runs"], wall_s=time.time() - t0)
            return launches
        c = got["cli"]
        if len(c["rows"]) != len(one_rows):
            raise AssertionError(f"{label} runner: rows {c['rows']}")
        rows_rel, acc = 0.0, 0.0
        for rg, rw in zip(c["rows"], one_rows):
            for k in rw:
                g, w = float(rg[k]), float(rw[k])
                if "acc" in k:
                    acc = max(acc, abs(g - w))
                else:
                    rows_rel = max(rows_rel, abs(g - w) / max(abs(w), 1e-30))
        if rows_rel > TP2_METRIC_TOL or acc > TP2_ACC_TOL:
            raise AssertionError(f"{label} runner: result.csv {c['rows']} "
                                 f"against one process's {one_rows}")
        # the run's checkpoints, loaded by this one process
        exp = cli_dir / "exp"
        rcfg = PretrainConfig(model=pretrain_config(
            "cav-mae-base", dtype=torch.bfloat16, mmixed_impl="exact"),
            batch_size=64)
        fresh = init_state(rcfg, torch.Generator(device="cuda").manual_seed(
            seed), "cuda")
        ck.restore_train_state(str(exp), "train_state.1", fresh)
        n_state = same_bits(f"{label} train_state.1", digests(
            fresh.model.named_parameters()), c["params"])
        fresh.model.load_state_dict(ck.restore_params(
            str(exp), "best_audio_model", map_location="cuda"))
        del fresh
        torch.cuda.empty_cache()
        for k, n in c["launches"].items():
            launches[k] = launches.get(k, 0) + n
        log(f"  {label} runner (--mesh_model 2): {c['steps']} steps, "
            f"{c['evals']} validation batch(es) in {c['runner_s']:.1f} s, "
            f"peak {c['peak_gib']:.1f} GiB a rank; result.csv within "
            f"{rows_rel:.2e} relative (<= {TP2_METRIC_TOL}), accuracies "
            f"within {acc:.4f} (<= {TP2_ACC_TOL}) of the one-process run's; "
            f"train_state.1 loaded by one process, {n_state} parameters the "
            f"same bits as the run's gathered ones; launches " + ", ".join(
                f"{k} {n}" for k, n in c["launches"].items() if n)
            + " as expected")
        wall = time.time() - t0
        log(f"  {label}: {wall:.1f} s ({workers_s:.1f} s with the launcher)")
        report.setdefault("steps", {})[label] = dict(
            wall_s=wall, workers_s=workers_s, runs=got["runs"],
            references={k: {x: v[x] for x in ("ms", "peak_gib", "metrics")}
                        for k, v in refs.items()},
            runner=dict(rows_rel=rows_rel, acc_diff=acc, one_process_s=one_s,
                        **{k: c[k] for k in ("runner_s", "steps", "evals",
                                             "peak_gib", "launches")}),
            launches=launches)
        return launches
    finally:
        shutil.rmtree(tp_dir, ignore_errors=True)


# ------------------------------------------------------- retrieval phase
RET_TOL = 2e-2  # bf16 kernels against float32 plain versions


def retrieval_launches(cfg, batch: int) -> dict:
    """Each kernel's launches of one 'retrieval' forward: the audio trunk
    and the video trunk over one frame, no fusion layers."""
    parts = ft_part_shapes(cfg, batch)
    attn, mlp = {}, {}
    for p in ("a", "v"):
        for table, add in zip((attn, mlp), parts[p]):
            for k, c in add.items():
                table[k] = table.get(k, 0) + c
    return forward_launches(cfg, Shapes(attn, mlp, {}, {}, {}, set()))


def run_retrieval(label, seed, report, ft_params):
    """Phase RET: the port's retrieval runner, ``avsiam_tpu_torch.cli.
    retrieval.main``, on FT64's ``best_audio_model`` (``ft_params``) over
    FT64's 64 eval clips, with the VGGSound recipe's model, classes,
    target length and normalisation, batch 64, on the card: R@1, R@5,
    R@10 and MR in both directions, the launches one 'retrieval' forward a
    batch implies (counted from 0 just before). Then the features of the
    same clips through the kernels (the recipe's bf16 model) against the
    plain versions (float32, attention 'xla', MLP 'dense', no kernel
    launched) on the card, from the same parameters: within ``RET_TOL``
    relative; and the forward's device time a batch, each way. Returns
    the runner's launch counts."""
    import csv
    import gc
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np

    from avsiam_tpu_torch import kernels
    from avsiam_tpu_torch.cli import finetune as ft_cli
    from avsiam_tpu_torch.cli import retrieval as cli
    from avsiam_tpu_torch.cli.common import (audio_config_from_args,
                                             dataset_from_args)
    from avsiam_tpu_torch.configs import FinetuneConfig, replace
    from avsiam_tpu_torch.data.dataset import make_eval_transform
    from avsiam_tpu_torch.models.cavmae_ft import CAVMAEFinetune
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_ret"
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=root))
    rec = ft_cli.build_parser().parse_args(recipe_argv(
        FT_RECIPE, "finetune", DATA_TRAIN="", DATA_VAL="", LABEL_CSV="",
        PRETRAIN="None", EXP_DIR=""))
    index = tmp / "eval.json"
    index.write_text(json.dumps({"data": [
        {"wav": f"synthetic/eval.json/{i}.wav",
         "labels": f"/m/{i % FT_CLASSES}"} for i in range(FT_EVAL_CLIPS)]}))
    labels = tmp / "labels.csv"
    labels.write_text("index,mid,display_name\n" + "".join(
        f"{i},/m/{i},class {i}\n" for i in range(FT_CLASSES)))
    argv = ["--data-val", str(index), "--label-csv", str(labels),
            "--n_class", str(rec.n_class), "--model", rec.model,
            "--target_length", str(rec.target_length), "--dataset_mean",
            str(rec.dataset_mean), "--dataset_std", str(rec.dataset_std),
            "--batch-size", "64", "--frame_source", "synthetic",
            "--exp-dir", str(tmp / "exp"), "--pretrain_path", str(ft_params)]
    log(f"phase {label}: python -m avsiam_tpu_torch.cli.retrieval "
        f"{' '.join(argv)}")
    os.environ.pop("AVSIAM_PLATFORM", None)  # the card
    try:
        kernels.reset_launches()
        t0 = time.time()
        rows = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(kernels.LAUNCHES)
        args = cli.build_parser().parse_args(argv)
        model = CAVMAEFinetune(cli.model_config(args), "cuda")
        cli.load_params(str(ft_params), model)
        n_batches = -(-FT_EVAL_CLIPS // 64)
        want = {k: n * n_batches for k, n in retrieval_launches(
            FinetuneConfig(model=model.cfg), 64).items()}
        if launches != want:
            raise AssertionError(f"{label}: launches {launches} != {want}")
        for r in rows:
            log(f"  {label} {r['direction']}: R@1 {r['R1']:.4f} R@5 "
                f"{r['R5']:.4f} R@10 {r['R10']:.4f} MR {r['MR']:.1f}")
        with open(tmp / "exp" / "retrieval_result.csv", newline="") as f:
            written = [r["direction"] for r in csv.DictReader(f)]
        if written != ["audio", "video"]:
            raise AssertionError(f"{label}: retrieval_result.csv {written}")
        ds = dataset_from_args(args, str(index), train=False,
                               num_mel_bins=model.cfg.vit.mel_bins,
                               im_res=model.cfg.vit.img_size,
                               frame_use=args.frame_use)
        plain = CAVMAEFinetune(replace(model.cfg, dtype=torch.float32,
                                       attn_impl="xla", mlp_impl="dense"),
                               "cuda")
        plain.load_state_dict(model.state_dict())
        feats = {}
        for name, m in (("kernels", model), ("plain", plain)):
            kernels.reset_launches()
            feats[name] = cli.extract_features(args, m, ds)
            if name == "plain" and any(kernels.LAUNCHES.values()):
                raise AssertionError(f"{label}: the plain model launched "
                                     f"{kernels.LAUNCHES}")
        errs = [float(np.abs(k - p).max() / np.abs(p).max()) for k, p in
                zip(feats["kernels"], feats["plain"])]
        host = ds.batch(list(range(64)), np.random.RandomState(0),
                        frames_per_sample=1)
        fb, img, _ = make_eval_transform(audio_config_from_args(
            args, train=False, num_mel_bins=model.cfg.vit.mel_bins),
            im_res=model.cfg.vit.img_size)(*(torch.from_numpy(
                np.ascontiguousarray(x)).cuda() for x in host))
        times = {}
        with torch.no_grad():
            for name, m in (("kernels", model), ("plain", plain)):
                times[name] = time_ms(lambda m=m: m(fb, img, "retrieval"),
                                      iters=5, warmup=2)
        log(f"  {label}: features of {FT_EVAL_CLIPS} clips, kernels (bf16) "
            f"against plain (float32) on the card: audio rel err "
            f"{errs[0]:.2e}, video {errs[1]:.2e} (<= {RET_TOL}); forward "
            f"{times['kernels']:.2f} ms a batch of 64 (plain "
            f"{times['plain']:.2f} ms), device time; the runner {wall:.1f} s "
            f"with its host batch; launches "
            + ", ".join(f"{k} {n}" for k, n in launches.items() if n)
            + " as expected")
        if not max(errs) <= RET_TOL:
            raise AssertionError(f"{label}: features differ from the plain "
                                 f"versions by {errs}")
        report.setdefault("steps", {})[label] = dict(
            batch=64, rows=rows, wall_s=wall, feature_rel_err=errs,
            forward_ms=times["kernels"], plain_forward_ms=times["plain"],
            launches=launches)
        del model, plain
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------- A12's new modules
AO_BATCH, AO_STEPS, AO_CLASSES = 64, 3, 527  # the AudioSet label set
AO_LOSS_TOL, AO_COS_TOL = 2e-2, 0.99  # as FTR


def grad_cosine(a: dict, b: dict) -> float:
    """The cosine between two {name: gradient} sets over the same names."""
    ga = torch.cat([a[n].double().cpu().flatten() for n in sorted(a)])
    gb = torch.cat([b[n].double().cpu().flatten() for n in sorted(a)])
    return float(torch.nn.functional.cosine_similarity(ga, gb, dim=0))


def run_audio_only(label, seed, report):
    """Phase AO: the audio-only finetune model (``models/audio_only.py``)
    at ViT-B width (11 audio blocks + 1 unified, a 1024 x 128 fbank: 512
    tokens), 527 classes, B=64, bf16, 'auto' attention and MLP: ``AO_STEPS``
    eager forward and BCE-backward steps on random multi-hot labels, each
    timed on the host clock to a sync; the launches, counted from 0 just
    before, exactly 12 K1, 12 K3 and 12 K2 a step. Then the reference at
    depth 2 (one block of each kind), B=2: the bf16 kernels on the card
    against the float32 plain model on the CPU from the same parameters,
    the loss within 2e-2 relative and the gradients' cosine at least 0.99,
    with ``tr_pos=False``: the position table takes no gradient on the card
    (exactly zero: none reaches it). Returns the launch counts."""
    from avsiam_tpu_torch import kernels
    from avsiam_tpu_torch.configs import ViTConfig
    from avsiam_tpu_torch.models import CAVMAEFTAudio
    from avsiam_tpu_torch.train.finetune import bce_with_logits
    vit = ViTConfig()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = CAVMAEFTAudio(vit, AO_CLASSES, dtype=torch.bfloat16,
                          generator=gen)
    log(f"phase {label}: the audio-only model, ViT dim {vit.dim}, "
        f"{len(model.blocks_a)} + {len(model.blocks_u)} blocks, "
        f"{vit.num_audio_tokens} tokens, batch {AO_BATCH}, bf16, 'auto': "
        f"{AO_STEPS} eager forward and BCE-backward steps")
    a = torch.randn((AO_BATCH, vit.audio_length, vit.mel_bins),
                    generator=gen, device="cuda")
    y = (torch.rand((AO_BATCH, AO_CLASSES), generator=gen, device="cuda")
         < 0.05).float()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    steps = []
    for i in range(AO_STEPS):
        t = time.time()
        model.zero_grad(set_to_none=True)
        loss = bce_with_logits(model.forward_pred(a), y)
        loss.backward()
        loss = float(loss.detach())
        torch.cuda.synchronize()
        steps.append(dict(loss=loss, ms=(time.time() - t) * 1e3))
        log(f"  {label} step {i}: loss {loss:.5f}  {steps[-1]['ms']:.1f} ms")
        if not math.isfinite(loss):
            raise AssertionError(f"{label}: non-finite loss at step {i}")
    launches = dict(kernels.LAUNCHES)
    depth = vit.depth
    per_step = {k: depth if k in ("attention_fwd", "ln_mlp_fwd",
                                  "attention_bwd") else 0
                for k in kernels.LAUNCHES}
    check_launches(label, launches, per_step, AO_STEPS)
    peak, _ = memory_gib()
    steady = median_after_first(steps)
    log(f"  {label} steady step: {steady:.1f} ms (median of steps 1.."
        f"{AO_STEPS - 1}), peak {peak:.2f} GiB allocated; a step: "
        f"{depth} K1, {depth} K3, {depth} K2")
    del model, a, y
    torch.cuda.empty_cache()

    cfg_small = ViTConfig(depth=2)
    card = CAVMAEFTAudio(cfg_small, AO_CLASSES, modality_specific_depth=1,
                         tr_pos=False, dtype=torch.bfloat16, generator=gen)
    cpu = CAVMAEFTAudio(cfg_small, AO_CLASSES, modality_specific_depth=1,
                        tr_pos=False, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
    cgen = torch.Generator().manual_seed(seed + 5)
    a = torch.randn((2, vit.audio_length, vit.mel_bins), generator=cgen)
    y = (torch.rand((2, AO_CLASSES), generator=cgen) < 0.05).float()
    kernels.reset_launches()
    lk = bce_with_logits(card.forward_pred(a.cuda()), y.cuda())
    lk.backward()
    ref_launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
    lc = bce_with_logits(cpu.forward_pred(a), y)
    lc.backward()
    lk, lc = float(lk.detach()), float(lc.detach())
    rel = abs(lk - lc) / max(abs(lc), 1e-6)
    got = {n: p.grad for n, p in card.named_parameters()
           if p.grad is not None}
    want = {n: p.grad for n, p in cpu.named_parameters()
            if p.grad is not None}
    if set(got) != set(want):
        raise AssertionError(f"{label}: the card reached other parameters "
                             f"than the CPU")
    cos = grad_cosine(got, want)
    pos = card.pos_embed_a.grad
    pos_zero = pos is None or not bool(pos.any())
    pos_says = ("None (none reaches it)" if pos is None
                else "zero" if pos_zero else "NOT zero")
    log(f"  {label} reference (depth 2, batch 2): kernel loss {lk:.6f} plain "
        f"{lc:.6f} rel err {rel:.2e} (<= {AO_LOSS_TOL}); gradient cosine "
        f"{cos:.6f} over {len(got)} tensors (>= {AO_COS_TOL}); launches "
        f"{ref_launches}; tr_pos=False: pos_embed_a's gradient {pos_says}")
    if rel > AO_LOSS_TOL or not cos >= AO_COS_TOL or not pos_zero:
        raise AssertionError(f"{label} reference: loss rel err {rel}, "
                             f"gradient cosine {cos}, pos_embed_a's "
                             f"gradient zero {pos_zero}")
    report.setdefault("steps", {})[label] = dict(
        batch=AO_BATCH, steps=steps, launches=launches,
        eager_steady_ms=steady, eager_peak_gib=peak,
        reference=dict(kernel=lk, plain=lc, rel=rel, grad_cos=cos,
                       pos_grad_zero=pos_zero))
    del card, cpu
    torch.cuda.empty_cache()
    return launches


TOME_BATCH = 64
TOME_CASES = (("a", 512, 16), ("a", 512, 64), ("v", 196, 16), ("v", 196, 64))
TOME_TOL = 2e-2  # bf16 kernels against float32 plain versions


def run_tome(label, seed, report):
    """Phase TOME: one ViT-B block with r > 0 (``ModalityBlock.forward(x,
    modality, None, r)``, ``models/tome.py``) at full width, B=64, bf16,
    'auto' (K1 in the attention, K3 over the merged tokens), audio N=512
    with 'a' norms and video N=196 with 'v', r 16 and 64; against the same
    block in float32 on its plain routes ('xla' attention, 'dense' MLP) on
    the card. bf16 reorders near-ties of the similarity ranking, so the
    card's plan need not be the plain one's; the pieces are held instead:

    - the attention output and the matching metric within 2e-2;
    - ``keep`` false at exactly r slots a sample, on both;
    - the plans' agreement, printed (the share of samples with the same
      plan, and of A tokens with the same fate);
    - under one shared plan (the plain one), the merge and the MLP
      residual within 2e-2 over the kept slots;
    - the token mass, sum of size * x over the kept slots, within 2e-2 of
      the unmerged tokens' sum.

    Then the whole block's r > 0 call: r slots dropped a sample, finite,
    its device time beside the plain block's (``event_ms``). The launches
    of each case, counted from 0 just before it: 2 K1 and 2 K3 (the
    pieces', the whole call's). Returns the summed launch counts."""
    from avsiam_tpu_torch import kernels
    from avsiam_tpu_torch.configs import ViTConfig
    from avsiam_tpu_torch.models.layers import ModalityBlock
    from avsiam_tpu_torch.models.tome import (bipartite_soft_matching,
                                              merge_wavg)
    v = ViTConfig()
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)

    def block(dtype, attn, mlp):
        return ModalityBlock(v.dim, v.num_heads, v.mlp_ratio, v.qkv_bias,
                             v.block_ln_eps, dtype, attn, v.gelu, mlp, "cuda")

    blk = block(torch.bfloat16, "auto", "auto")
    with torch.no_grad():  # nonzero biases, so that each one shows
        for m in blk.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
            if hasattr(m, "bias") and isinstance(m.bias, torch.nn.Parameter):
                m.bias.normal_(0.0, 0.02, generator=gen)
    plain = block(torch.float32, "xla", "dense")
    plain.load_state_dict(blk.state_dict())
    log(f"phase {label}: one ViT-B block with r > 0, batch {TOME_BATCH}, "
        f"bf16 'auto' against float32 'xla'/'dense' on the card "
        f"(<= {TOME_TOL})")
    total = {k: 0 for k in kernels.LAUNCHES}
    rows = []
    for modality, n, r in TOME_CASES:
        x = torch.randn((TOME_BATCH, n, v.dim), generator=gen,
                        device="cuda").to(torch.bfloat16)
        xf = x.float()
        n1k, n2k = blk._norms(modality)
        n1p, n2p = plain._norms(modality)
        kernels.reset_launches()
        with torch.no_grad():
            attn_k, metric_k = blk.attn(n1k(x), None, tome=True)
            attn_p, metric_p = plain.attn(n1p(xf), None, tome=True)
            plan_k = bipartite_soft_matching(metric_k, r)
            assign, keep = bipartite_soft_matching(metric_p, r)
            xk, xp = x + attn_k, xf + attn_p
            mk, sk = merge_wavg(assign, xk)
            mp, _ = merge_wavg(assign, xp)
            out_k = blk._mlp_res(mk, n2k)
            out_p = plain._mlp_res(mp, n2p)
            mass = (mk.float() * sk.float() * keep[..., None]).sum(dim=1)
            whole, whole_keep = blk(x, modality, None, r)
        launches = dict(kernels.LAUNCHES)
        want = {k: 2 if k in ("attention_fwd", "ln_mlp_fwd") else 0
                for k in kernels.LAUNCHES}
        if launches != want:
            raise AssertionError(f"{label} {modality} N={n} r={r}: launches "
                                 f"{launches} != {want}")
        for k, c in launches.items():
            total[k] += c
        errs = dict(attn=rel_err(attn_k, attn_p)[1],
                    metric=rel_err(metric_k, metric_p)[1],
                    merge_mlp=rel_err(out_k[keep], out_p[keep])[1],
                    mass=rel_err(mass, xk.float().sum(dim=1))[1])
        dropped = [int(d) for d in (~plan_k[1]).sum(dim=1).unique()] + [
            int(d) for d in (~keep).sum(dim=1).unique()] + [
            int(d) for d in (~whole_keep).sum(dim=1).unique()]
        same_plan = float((plan_k[0] == assign).flatten(1).all(1).float()
                          .mean())
        a_idx = torch.arange(0, n, 2, device="cuda")
        same_fate = float((plan_k[0][:, a_idx] == assign[:, a_idx])
                          .all(-1).float().mean())
        finite = bool(torch.isfinite(whole.float()).all())
        with torch.no_grad():
            ms = event_ms(lambda: blk(x, modality, None, r))
            plain_ms_ = event_ms(lambda: plain(xf, modality, None, r))
        rows.append(dict(modality=modality, N=n, r=r, errs=errs,
                         same_plan=same_plan, same_fate=same_fate, ms=ms,
                         plain_ms=plain_ms_, launches=launches))
        log(f"  {label} {modality} N={n} r={r}: attention {errs['attn']:.2e}, "
            f"metric {errs['metric']:.2e}, merge + MLP residual "
            f"{errs['merge_mlp']:.2e}, token mass {errs['mass']:.2e} "
            f"(<= {TOME_TOL}); dropped {sorted(set(dropped))} a sample; "
            f"plans agree in {same_plan:.1%} of samples, {same_fate:.2%} of "
            f"A tokens; the block {ms:.3f} ms (plain {plain_ms_:.3f}), "
            f"device time; launches K1 2, K3 2 as expected")
        if (max(errs.values()) > TOME_TOL or set(dropped) != {r}
                or not finite):
            raise AssertionError(f"{label} {modality} N={n} r={r}: errors "
                                 f"{errs}, dropped {dropped}, finite "
                                 f"{finite}")
    report.setdefault("steps", {})[label] = dict(batch=TOME_BATCH,
                                                 rows=rows, launches=total)
    del blk, plain
    torch.cuda.empty_cache()
    return total


MEM_TOL = 0.10  # the probe's peak against phase A's eager peak, relative


def start_memory_probe(label):
    """Phase MEM's start: ``python -m avsiam_tpu_torch.cli.memory_probe
    --model cav-mae-base --batch-size 8 --steps 3`` as a user runs it, on
    the card, in a process of its own, so that its peak is its own; it
    runs beside the reference phases, which check values and time
    nothing. Returns (the process, its start time)."""
    cmd = [sys.executable, "-m", "avsiam_tpu_torch.cli.memory_probe",
           "--model", "cav-mae-base", "--batch-size", "8", "--steps", "3"]
    log(f"phase {label}: {' '.join(cmd[1:])}, beside the reference phases")
    env = dict(os.environ)
    env.pop("AVSIAM_PLATFORM", None)
    torch.cuda.empty_cache()
    return (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, env=env,
                             cwd=os.path.dirname(os.path.abspath(__file__))),
            time.time())


def check_memory_probe(label, report, a_peak_gib, started):
    """Phase MEM's end: the probe's JSON line, and its peak within 10% of
    phase A's eager peak ``a_peak_gib`` (the same model and batch, eager;
    the probe adds the initial state's allocation and takes the config's
    default contrastive form, 'padded', where A takes 'exact')."""
    proc, t = started
    out, err = proc.communicate(timeout=600)
    wall = time.time() - t
    if proc.returncode:
        raise AssertionError(f"{label}: exit {proc.returncode}\n"
                             f"{err[-4000:]}")
    line = out.strip().splitlines()[-1]
    res = json.loads(line)
    log(f"  {line}")
    peak = res["memory"]["peak_bytes_in_use"] / 2**30
    rel = abs(peak - a_peak_gib) / a_peak_gib
    log(f"  {label}: {wall:.1f} s from its start; peak {peak:.2f} GiB "
        f"against phase A's eager {a_peak_gib:.2f} GiB: {rel:.1%} apart "
        f"(<= {MEM_TOL:.0%}); {res['params_million']} M parameters, "
        f"{res['optimizer_state_million']} M optimizer state")
    if rel > MEM_TOL:
        raise AssertionError(f"{label}: peak {peak:.2f} GiB is {rel:.1%} "
                             f"from phase A's {a_peak_gib:.2f}")
    report.setdefault("steps", {})[label] = dict(res, wall_s=wall,
                                                 peak_gib=peak, a_rel=rel)


def run_ft_reference(seed, report, batch: int = 2):
    """Phase FTR: the finetune step in each 'mm_grad' branch (the routing
    draw given), bf16 kernels on the card against the plain versions in
    float32 on the CPU from the same parameters before the step: ViT-B
    width, depth 1, the recipe's 309 classes and CE loss; the loss within
    2e-2 relative and the gradients' cosine at least 0.99, over the
    parameters the branch reaches (the same set on both)."""
    from avsiam_tpu_torch.configs import (CAVMAEFTConfig, FinetuneConfig,
                                          ViTConfig, replace)
    from avsiam_tpu_torch.models.cavmae_ft import CAVMAEFinetune
    from avsiam_tpu_torch.train import finetune as ft
    loss_tol, cos_tol = 2e-2, 0.99
    cfg = FinetuneConfig(model=CAVMAEFTConfig(
        vit=ViTConfig(depth=1), label_dim=FT_CLASSES, num_eval_frames=2,
        dtype=torch.bfloat16), batch_size=batch, loss="CE")
    log(f"phase FTR: the finetune step per branch, depth 1, batch {batch}: "
        f"bf16 kernels on the card vs float32 plain versions on the CPU "
        f"(loss rel err <= {loss_tol}, gradient cosine >= {cos_tol})")
    state = ft.init_state(cfg, torch.Generator(device="cuda").manual_seed(
        seed + 3), "cuda")
    cpu = CAVMAEFinetune(replace(cfg.model, dtype=torch.float32), "cpu")
    step = ft.make_finetune_step(cfg)
    cgen = torch.Generator().manual_seed(seed + 4)
    v = cfg.model.vit
    a = torch.randn((batch, v.audio_length, v.mel_bins), generator=cgen)
    imgs = torch.randn((batch, 1, 3, v.img_size, v.img_size), generator=cgen)
    y = torch.softmax(torch.randn((batch, FT_CLASSES), generator=cgen), -1)
    results = {}
    for branch, u in (("av", 0.9), ("a", 0.1), ("v", 0.4)):
        cpu.load_state_dict({k: t.cpu() for k, t in
                             state.model.state_dict().items()})
        cpu.zero_grad(set_to_none=True)
        state, m = step(state, (a.cuda(), imgs.cuda(), y.cuda()), 1e-5, u)
        outs = dict(zip(ft.BRANCHES, cpu(a, imgs, "mm_grad")))
        loss = ft.ce_with_soft_targets(outs[branch], y)
        loss.backward()
        got = dict(state.model.named_parameters())
        names = [n for n, p in cpu.named_parameters() if p.grad is not None]
        if names != [n for n, p in got.items() if p.grad is not None]:
            raise AssertionError(f"FTR {branch}: the card reached other "
                                 f"parameters than the CPU")
        gg = torch.cat([got[n].grad.double().cpu().flatten() for n in names])
        gc_ = torch.cat([p.grad.double().flatten()
                         for n, p in cpu.named_parameters()
                         if p.grad is not None])
        cos = float(torch.nn.functional.cosine_similarity(gg, gc_, dim=0))
        lk, lc = float(m["loss"]), float(loss.detach())
        rel = abs(lk - lc) / max(abs(lc), 1e-6)
        log(f"  {branch}: kernel loss {lk:.6f} plain {lc:.6f} rel err "
            f"{rel:.2e}; gradient cosine {cos:.6f} over {gg.numel()} values "
            f"({len(names)} tensors)")
        if rel > loss_tol or not cos >= cos_tol:
            raise AssertionError(f"FTR {branch}: loss rel err {rel}, "
                                 f"gradient cosine {cos}")
        results[branch] = dict(kernel=lk, plain=lc, rel=rel, grad_cos=cos,
                               tensors=len(names))
    report.setdefault("reference", {})["FTR"] = results
    del state, cpu
    torch.cuda.empty_cache()


def compare_eager_graphed(cfg, seed, n_steps: int = 3, tol: float = 1e-5,
                          keep=None):
    """Two states from one seed: ``n_steps`` eager steps of one against as
    many calls of the graphed step (warm-up, capture, replay) of the other,
    with draws from generators of one seed and the learning rate halved
    each step (so a replay must read the rate written before it). Each
    step's metrics and, at the end, every parameter and both Adams' moments
    must agree within ``tol`` relative (max |delta| / max |eager| per
    tensor); identical bits are expected. Returns the largest difference
    and where it was. With ``keep`` (a dict) the graphed run's end state
    (``digests``) and each step's metrics (``float.hex``) are kept there:
    DP1 holds the step under a process group against them."""
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
    if keep is not None:
        keep.update(state=digests(state_tensors(sg)), metrics=[
            {k: float(x).hex() for k, x in m.items()} for m in mg])
    diffs = {f"step {i} {k}": max_rel(g[k], e[k])
             for i, (e, g) in enumerate(zip(me, mg)) for k in e}
    diffs.update(state_diffs(sg, se))
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
    ("NCCL collectives", ("nccl",)),
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
    groups, group_calls, kernels_run, per_kernel = {}, {}, 0, []
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
        group_calls[group] = group_calls.get(group, 0) + e.count
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
                groups=groups, group_calls=group_calls, top=shown,
                calls=calls)


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
