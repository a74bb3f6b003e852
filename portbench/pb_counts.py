"""Operations and bytes of the steps the benchmark drives, from shapes alone.

Everything here reads the benchmark's own configuration files (plain dicts)
and imports nothing of the program, so a later change to the program cannot
move the yardstick. The rules that decide which kernel a shape goes to
(``chunk_sizes``, ``len_keep_for``, ``mlp_route``, ``attention_route``)
are copies of the program's, frozen here.

Two kinds of count:

- model operations (``*_model_flops``): the forward's matrix products
  (linear layers, attention's two products, the InfoNCE logits) and twice
  that for the backward of what the step's losses reach; the patch
  embeddings' backward takes only the weight gradient. Rematerialised
  forwards are not counted. This feeds ``mfu``.
- kernel calls (``*_kernel_calls``): every call the step makes of the
  port's attention kernels and of its LN and MLP kernels, with the least
  time the chip could take for it (``bound_s``): the larger of its
  operations over the bf16 peak and its bytes over the memory bandwidth,
  each input read once and each output written once. A kernel's own
  recomputation inside a call (attention's backward redoing q k^T, the
  fused MLP's backward redoing fc1) is its choice and is not counted. A
  forward that ``remat_blocks`` (a memory setting of the configuration)
  runs again in the backward is a whole call of its own: it is counted as
  a forward, under the pass 'remat', apart from the backward. This feeds
  the ``*_roofline`` shares.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())
LANE = 128


# ------------------------------------------------ frozen copies of the rules
def chunk_sizes(batch: int, num_chunks: int) -> list:
    """torch.chunk's sizes: ceil(B/n) each, the last smaller, none empty."""
    size = -(-batch // num_chunks)
    sizes, rem = [], batch
    while rem > 0:
        sizes.append(min(size, rem))
        rem -= size
    return sizes


def len_keep_for(n: int, mask_ratio: float) -> int:
    return int(n * (1.0 - mask_ratio))


def mlp_route(impl: str, dim: int, hidden: int) -> str:
    """'auto' is 'lnfres' where D and H are multiples of 128, else 'dense'."""
    if impl != "auto":
        return impl
    return "lnfres" if dim % LANE == 0 and hidden % LANE == 0 else "dense"


def attention_route(impl: str, dim: int, heads: int) -> str:
    """'token_major' (K1/K2) where C % 128 == 0 and D divides 128, under
    'auto' and 'pallas'; else 'head_major' (K5/K6) under 'pallas' and the
    torch ops ('xla') otherwise."""
    d = dim // heads
    if impl == "xla":
        return "xla"
    if dim % LANE == 0 and LANE % d == 0:
        return "token_major"
    return "head_major" if impl == "pallas" else "xla"


# ------------------------------------------------------------ geometry
def geometry(cfg: dict) -> dict:
    v, d = cfg["vit"], cfg["decoder"]
    p = v["patch_size"]
    f, t = v["mel_bins"] // p, v["audio_length"] // p
    g = v["img_size"] // p
    return dict(D=v["dim"], depth=v["depth"], heads=v["num_heads"],
                H=int(v["dim"] * v["mlp_ratio"]), p=p, f=f, t=t,
                La=f * t, Lv=g * g, Dd=d["dim"], dec_depth=d["depth"],
                dec_heads=d["num_heads"], Hd=int(d["dim"] * d["mlp_ratio"]))


# ------------------------------------------------------- model operations
def linear_flops(rows: int, fan_in: int, fan_out: int) -> int:
    return 2 * rows * fan_in * fan_out


def block_flops(b: int, n: int, dim: int, hidden: int) -> int:
    """One transformer block's forward products over b x n tokens: qkv,
    proj, fc1, fc2 and attention's q k^T and p v."""
    rows = b * n
    return (linear_flops(rows, dim, 3 * dim) + linear_flops(rows, dim, dim)
            + 2 * linear_flops(rows, dim, hidden) + 4 * b * n * n * dim)


def contrastive_chunks(cfg: dict, batch: int) -> list:
    """[(chunk size, audio keep, video keep)] of the 'exact' contrastive
    pass: chunk i of the permuted batch masked at ratio step * i."""
    g = geometry(cfg)
    step = cfg["mmixed_ratio_step"]
    return [(b, len_keep_for(g["La"], step * i), len_keep_for(g["Lv"], step * i))
            for i, b in enumerate(chunk_sizes(batch, cfg["mmixed_num_chunks"]))]


def embed_flops(cfg: dict, batch: int) -> tuple:
    """(audio, video) patch embeddings' forward products over every token."""
    g = geometry(cfg)
    return (linear_flops(batch * g["La"], g["p"] ** 2, g["D"]),
            linear_flops(batch * g["Lv"], 3 * g["p"] ** 2, g["D"]))


def pretrain_model_flops(cfg: dict, batch: int) -> float:
    """Model operations of one two-pass pretrain step ('exact' form, both
    losses): each pass's forward, and its backward at twice the forward
    but for the patch embeddings' (the weight gradient only)."""
    g = geometry(cfg)
    D, H = g["D"], g["H"]
    emb = sum(embed_flops(cfg, batch))
    # pass 1: every chunk's audio and video through the trunk, InfoNCE
    trunk1 = sum(g["depth"] * (block_flops(b, ka, D, H) + block_flops(b, kv, D, H))
                 for b, ka, kv in contrastive_chunks(cfg, batch))
    nce = linear_flops(batch, D, batch)  # a v^T, which both directions read
    pass1 = trunk1 + nce
    # pass 2: masked trunks, the two fusion blocks, the decoder
    ka = len_keep_for(g["La"], cfg["mae_mask_ratio"])
    kv = len_keep_for(g["Lv"], cfg["mae_mask_ratio"])
    L = g["La"] + g["Lv"]
    pass2 = (g["depth"] * (block_flops(batch, ka, D, H) + block_flops(batch, kv, D, H))
             + 2 * block_flops(batch, ka + kv, D, H)
             + linear_flops(batch * (ka + kv), D, g["Dd"])
             + g["dec_depth"] * block_flops(batch, L, g["Dd"], g["Hd"])
             + linear_flops(batch * g["La"], g["Dd"], g["p"] ** 2)
             + linear_flops(batch * g["Lv"], g["Dd"], 3 * g["p"] ** 2))
    return float(3 * (pass1 + pass2) + 2 * 2 * emb)


# the parts each branch's loss reaches: the fused loss the trunks and the
# fusion blocks with the fused head, a single-modality loss its trunk and
# its own head
FT_PARTS = {"av": ("a", "v", "mm"), "a": ("a", "head_a"), "v": ("v", "head_v")}


def finetune_part_flops(cfg: dict, batch: int, classes: int) -> dict:
    """Forward products of the finetune model's parts: the audio and video
    trunks ('a', 'v'), the fusion blocks with the fused head ('mm'), the
    audio and video heads, and the patch embeddings ('emb_a', 'emb_v')."""
    g = geometry(cfg)
    D, H = g["D"], g["H"]
    ea, ev = embed_flops(cfg, batch)
    return {"a": g["depth"] * block_flops(batch, g["La"], D, H),
            "v": g["depth"] * block_flops(batch, g["Lv"], D, H),
            "mm": 2 * block_flops(batch, g["La"] + g["Lv"], D, H)
                  + linear_flops(batch, 2 * D, classes),
            "head_a": linear_flops(batch, D, classes),
            "head_v": linear_flops(batch, D, classes),
            "emb_a": ea, "emb_v": ev}


def finetune_model_flops(cfg: dict, batch: int, classes: int,
                         branch: str) -> float:
    """Model operations of one 'mm_grad' finetune step of ``branch``: the
    forward of every part (the step computes all three logits), the
    backward of the parts the branch's loss reaches."""
    f = finetune_part_flops(cfg, batch, classes)
    fwd = sum(f.values())
    bwd = sum(2 * f[p] for p in FT_PARTS[branch])
    if "a" in FT_PARTS[branch]:
        bwd += f["emb_a"]
    if "v" in FT_PARTS[branch]:
        bwd += f["emb_v"]
    return float(fwd + bwd)


# ---------------------------------------------------------- kernel calls
def bound_s(flops: float, nbytes: float) -> float:
    """The least time of a call: operations over the bf16 peak or bytes over
    the memory bandwidth, whichever is longer."""
    return max(flops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"])


def attention_bounds(route: str, b: int, n: int, heads: int, d: int) -> tuple:
    """(forward, backward) bound seconds of one attention call on bf16
    q, k, v: operations q k^T and p v forward; do v^T, dv, dq and dk
    backward (the kernels' own recomputation of q k^T is not counted: it is
    their choice, not the function's need). Bytes: the forward reads q, k, v
    and writes o (and, token-major, the f32 row statistics); the backward
    reads q, k, v, o, do (and the statistics) and writes dq, dk, dv."""
    sq = b * heads * n * n * d
    tok = b * n * heads * d * 2
    st = b * heads * n * 8 if route == "token_major" else 0
    return (bound_s(4 * sq, 4 * tok + st), bound_s(8 * sq, 8 * tok + st))


def mlp_bounds(route: str, t: int, d: int, h: int) -> tuple:
    """(forward, backward) bound seconds of one MLP sub-block call over t
    rows, by route. 'lnfres' (K3): LN, fc1, GELU and fc2 with the residual,
    reading x and both weights, writing the output and the bf16 hidden; its
    backward runs in torch ops (None). 'fused' (K4, then K7 with K9):
    forward reads x and the weights and writes the output; the backward
    makes dh, dx, dw1, dw2 and the biases' gradients (f32): four products
    (the kernels' recomputation of fc1 is not counted)."""
    bb, fb = 2, 4
    if route == "lnfres":
        return (bound_s(4 * t * d * h, bb * (2 * t * d + 2 * d * h + t * h)),
                None)
    if route in ("fused", "fres", "fbwd"):
        return (bound_s(4 * t * d * h, bb * (2 * t * d + 2 * d * h) + fb * (h + d)),
                bound_s(8 * t * d * h, bb * (3 * t * d + 2 * d * h)
                        + fb * (2 * h + 2 * d * h + d)))
    return None, None


def _blocks(calls: list, family_cfg: dict, b: int, n: int, dim: int, heads: int,
            hidden: int, count: int, backward: bool, again: bool) -> None:
    """Append a block's (family, pass, bound seconds, calls) for ``count``
    blocks: the forward, the backward where ``backward``, and the forward
    run again ('remat') where ``again`` and ``backward``."""
    ar = attention_route(family_cfg["attn_impl"], dim, heads)
    mr = mlp_route(family_cfg["mlp_impl"], dim, hidden)
    fa, ba = attention_bounds(ar, b, n, heads, dim // heads)
    fm, bm = mlp_bounds(mr, b * n, dim, hidden)
    passes = ["forward"] + (["remat"] if again and backward else [])
    for family, fwd, bwd, routed in (("attention", fa, ba, ar != "xla"),
                                     ("mlp", fm, bm, fm is not None)):
        if not routed:
            continue
        calls += [(family, p, fwd, count) for p in passes]
        if backward and bwd is not None:
            calls.append((family, "backward", bwd, count))


def pretrain_kernel_calls(cfg: dict, batch: int) -> list:
    """[(family, pass, bound seconds, calls)] of one 'exact' two-pass
    pretrain step, family 'attention' or 'mlp', pass 'forward', 'backward'
    or 'remat'."""
    g = geometry(cfg)
    enc = dict(attn_impl=cfg["attn_impl"], mlp_impl=cfg["mlp_impl"])
    dec = dict(attn_impl=cfg["attn_impl"],
               mlp_impl=cfg["dec_mlp_impl"] or cfg["mlp_impl"])
    remat = cfg["remat_blocks"]
    calls = []
    for b, ka, kv in contrastive_chunks(cfg, batch):
        for n in (ka, kv):
            _blocks(calls, enc, b, n, g["D"], g["heads"], g["H"], g["depth"],
                    True, remat)
    ka = len_keep_for(g["La"], cfg["mae_mask_ratio"])
    kv = len_keep_for(g["Lv"], cfg["mae_mask_ratio"])
    for n in (ka, kv):
        _blocks(calls, enc, batch, n, g["D"], g["heads"], g["H"], g["depth"],
                True, remat)
    _blocks(calls, enc, batch, ka + kv, g["D"], g["heads"], g["H"], 2, True,
            False)
    _blocks(calls, dec, batch, g["La"] + g["Lv"], g["Dd"], g["dec_heads"],
            g["Hd"], g["dec_depth"], True, False)
    return calls


def finetune_kernel_calls(cfg: dict, batch: int, branch: str) -> list:
    """[(family, pass, bound seconds, calls)] of one 'mm_grad' finetune step of
    ``branch``: every part's forward, the backward of the branch's parts."""
    g = geometry(cfg)
    enc = dict(attn_impl=cfg["attn_impl"], mlp_impl=cfg["mlp_impl"])
    remat = cfg["remat_blocks"]
    calls = []
    for part, n, count in (("a", g["La"], g["depth"]),
                           ("v", g["Lv"], g["depth"]),
                           ("mm", g["La"] + g["Lv"], 2)):
        back = part in FT_PARTS[branch]
        _blocks(calls, enc, batch, n, g["D"], g["heads"], g["H"], count, back,
                remat and part != "mm")
    return calls


def family_bound_s(calls: list, family: str) -> float:
    return sum(s * n for fam, _, s, n in calls if fam == family)
