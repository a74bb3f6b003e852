"""The plain reference: the pretrain and finetune models and steps of AVSiam
(CAV-MAE) in float32 PyTorch, written from the published description.

It imports nothing of the program and takes nothing the program made: the
parameters are a dict of float32 tensors the benchmark makes from the seed
(``pb_weights``), keyed by the names ``param_spec`` gives, and the inputs
(batches, masking draws, routes) are the benchmark's. What the program
derives from them (its masks, gathers, casts) is worked out here again.
The masking rules (``keep_mask``, ``structured_noise``, ``random_masking``)
and the optimizer's touched sets (``touched_contrastive``, ``touched_mae``)
are frozen copies of the configuration's semantics, as the CAV-MAE
reference defines them.

Every product runs in float32 with TF32 off (``no_tf32``). Each trunk,
fusion and decoder block is rematerialised in the backward
(``torch.utils.checkpoint``) so that ViT-H at B=64 fits beside its Adam
state. ``fp8=True`` is the lower-precision control: the operands of every
linear layer and of attention's products are rounded to float8 e4m3 with a
per-tensor scale (amax to 448), the step the benchmark's correctness check
has to catch.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

import pb_weights
from pb_counts import chunk_sizes, geometry, len_keep_for

F8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 at a per-tensor scale; the gradient passes
    straight through (the rounded values are what the products see)."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / F8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


# ------------------------------------------------------------ parameters
def _dense(name, fan_in, fan_out):
    return [(f"{name}.weight", (fan_out, fan_in), "matrix"),
            (f"{name}.bias", (fan_out,), "bias")]


def _ln(name, dim):
    return [(f"{name}.weight", (dim,), "ln_weight"),
            (f"{name}.bias", (dim,), "ln_bias")]


def _block(name, dim, hidden):
    out = []
    for n in ("norm1", "norm1_a", "norm1_v", "norm2", "norm2_a", "norm2_v"):
        out += _ln(f"{name}.{n}", dim)
    return (out + _dense(f"{name}.attn.qkv", dim, 3 * dim)
            + _dense(f"{name}.attn.proj", dim, dim)
            + _dense(f"{name}.mlp.fc1", dim, hidden)
            + _dense(f"{name}.mlp.fc2", hidden, dim))


def _trunk(name, g):
    out = (_dense(f"{name}.patch_embed.proj", 3 * g["p"] ** 2, g["D"])
           + _dense(f"{name}.patch_embed_a.proj", g["p"] ** 2, g["D"])
           + [(f"{name}.pos_embed", (1, 1 + g["Lv"], g["D"]), "embed"),
              (f"{name}.pos_embed_a", (1, g["La"], g["D"]), "embed")])
    for i in range(g["depth"]):
        out += _block(f"{name}.blocks.{i}", g["D"], g["H"])
    return out + _ln(f"{name}.norm", g["D"]) + _ln(f"{name}.norm_a", g["D"])


def param_spec(cfg: dict, job: str, classes: Optional[int] = None
               ) -> List[Tuple[str, tuple, str]]:
    """[(name, shape, kind)] of every parameter of the job's model, kind
    one of 'matrix', 'bias', 'ln_weight', 'ln_bias', 'embed'."""
    g = geometry(cfg)
    if job == "pretrain":
        spec = _trunk("vit", g) + _trunk("ast", g)
        spec += _block("mm_layer_1", g["D"], g["H"])
        spec += _block("mm_layer_2", g["D"], g["H"])
        Dd = g["Dd"]
        spec += _dense("decoder.embed", g["D"], Dd)
        spec += [("decoder.pos_embed_a", (1, g["La"], Dd), "embed"),
                 ("decoder.pos_embed_v", (1, g["Lv"], Dd), "embed"),
                 ("decoder.mask_token", (1, 1, Dd), "embed"),
                 ("decoder.modality_a", (1, 1, Dd), "embed"),
                 ("decoder.modality_v", (1, 1, Dd), "embed")]
        for i in range(g["dec_depth"]):
            spec += _block(f"decoder.blocks.{i}", Dd, g["Hd"])
        spec += _ln("decoder.norm", Dd)
        spec += _dense("decoder.pred_a", Dd, g["p"] ** 2)
        spec += _dense("decoder.pred_v", Dd, 3 * g["p"] ** 2)
        return spec
    if job == "finetune":
        spec = _trunk("vit", g)
        for name, dim in (("mlp_head", g["D"]), ("mlp_head_a", g["D"]),
                          ("mlp_head_mm", 2 * g["D"]),
                          ("mlp_head_mm_v2", g["D"])):
            spec += _ln(f"{name}.ln", dim) + _dense(f"{name}.linear", dim,
                                                      classes)
        spec += _block("mm_layer_1", g["D"], g["H"])
        spec += _block("mm_layer_2", g["D"], g["H"])
        return spec
    raise ValueError(f"unknown job {job!r}")


# ------------------------------------------------------ the masking rules
def _argsort(x):
    return torch.argsort(x, dim=1, stable=True)


def keep_mask(noise, count: int):
    """[N, L] bool: the ``count`` smallest of each row (ties by position)."""
    return _argsort(_argsort(noise)) < count


def structured_noise(base, r_t, r_f, ratio: float):
    """CAV-MAE's 'tf' noise: ``int(t * ratio * 0.7)`` time columns and
    ``int(f * ratio * 0.7)`` frequency rows, chosen by the smallest of r_t
    and r_f, are set to 1.1, so that they are dropped first."""
    n, f, t = base.shape
    cols = keep_mask(r_t, int(t * ratio * 0.7))[:, None, :]
    rows = keep_mask(r_f, int(f * ratio * 0.7))[:, :, None]
    return torch.where(cols | rows, torch.full_like(base, 1.1),
                       base).reshape(n, f * t)


def gather_tokens(x, ids):
    return torch.gather(x, 1, ids[:, :, None].expand(-1, -1, x.shape[2]))


def random_masking(x, keep: int, noise):
    """MAE's masking: keep the ``keep`` tokens of smallest noise. Returns
    (kept [N, keep, C], mask [N, L] with 1 = removed, ids_restore)."""
    ids_shuffle = _argsort(noise)
    ids_restore = _argsort(ids_shuffle)
    mask = torch.ones(noise.shape, dtype=torch.float32, device=x.device)
    mask[:, :keep] = 0.0
    return (gather_tokens(x, ids_shuffle[:, :keep]),
            torch.gather(mask, 1, ids_restore), ids_restore)


def patchify(imgs, p: int):
    """[B, C, H, W] -> [B, (H/p)(W/p), p*p*C], patches in (p_h, p_w, c)
    order, row-major over the grid."""
    B, C, H, W = imgs.shape
    x = imgs.reshape(B, C, H // p, p, W // p, p).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def audio_image(fbank):
    """[B, T, F] fbank -> [B, 1, F, T]."""
    return fbank[:, None].transpose(2, 3)


# --------------------------------------------------------------- the model
class Model:
    """The forward of both models over the parameter dict ``P``; ``remat``:
    each block's forward runs again in the backward."""

    def __init__(self, cfg: dict, P: Dict[str, torch.Tensor],
                 fp8: bool = False, remat: bool = True):
        self.cfg, self.P, self.g, self.remat = cfg, P, geometry(cfg), remat
        self.q = _Fp8.apply if fp8 else (lambda x: x)

    def linear(self, x, name):
        return (self.q(x) @ self.q(self.P[f"{name}.weight"]).T
                + self.P[f"{name}.bias"])

    def norm(self, x, name, eps):
        return F.layer_norm(x, (x.shape[-1],), self.P[f"{name}.weight"],
                            self.P[f"{name}.bias"], eps)

    def attention(self, x, name, heads):
        B, N, C = x.shape
        d = C // heads
        qkv = self.linear(x, f"{name}.qkv").reshape(B, N, 3, heads, d)
        q, k, v = (self.q(t) for t in qkv.permute(2, 0, 3, 1, 4))
        p = torch.softmax(q @ k.transpose(-1, -2) * d ** -0.5, dim=-1)
        out = (self.q(p) @ v).transpose(1, 2).reshape(B, N, C)
        return self.linear(out, f"{name}.proj")

    def block(self, x, name, heads, eps, route=""):
        """Pre-LN block with the norm set ``route`` ('' shared, '_a', '_v')."""
        def body(x):
            x = x + self.attention(self.norm(x, f"{name}.norm1{route}", eps),
                                   f"{name}.attn", heads)
            h = self.linear(self.norm(x, f"{name}.norm2{route}", eps),
                            f"{name}.mlp.fc1")
            return x + self.linear(F.gelu(h), f"{name}.mlp.fc2")

        if self.remat and torch.is_grad_enabled():
            return checkpoint(body, x, use_reentrant=False)
        return body(x)

    def trunk(self, x, name, route):
        v = self.cfg["vit"]
        for i in range(v["depth"]):
            x = self.block(x, f"{name}.blocks.{i}", v["num_heads"],
                           v["block_ln_eps"], route)
        return x

    def final_norm(self, x, name):
        return self.norm(x, name, self.cfg["vit"]["final_ln_eps"])

    def fusion(self, x):
        v = self.cfg["vit"]
        for name in ("mm_layer_1", "mm_layer_2"):
            x = self.block(x, name, v["num_heads"], v["block_ln_eps"], "_a")
        return x

    def embed_audio(self, fbank, trunk="vit"):
        x = self.linear(patchify(audio_image(fbank), self.g["p"]),
                        f"{trunk}.patch_embed_a.proj")
        x = x + self.P[f"{trunk}.pos_embed_a"]
        return x + x if self.cfg["embed_double"] else x

    def embed_video(self, imgs, trunk="vit"):
        x = self.linear(patchify(imgs, self.g["p"]),
                        f"{trunk}.patch_embed.proj")
        x = x + self.P[f"{trunk}.pos_embed"][:, 1:]
        return x + x if self.cfg["embed_double"] else x

    # ------------------------------------------------------------ pretrain
    def contrastive(self, fbank, imgs, draws):
        """The multi-ratio contrastive pass, each chunk of the permuted
        batch masked at ratio step * i and encoded alone ('exact'), then
        the bidirectional InfoNCE: (loss, accuracy)."""
        c, g = self.cfg, self.g
        a, v = self.embed_audio(fbank), self.embed_video(imgs)
        B = a.shape[0]
        sizes = chunk_sizes(B, c["mmixed_num_chunks"])
        pooled_a, pooled_v, off = [], [], 0
        for i, b in enumerate(sizes):
            ratio = c["mmixed_ratio_step"] * i
            ai = a[draws["perm_a"][off:off + b]]
            noise = structured_noise(*draws["chunk_a"][i], ratio)
            ai = gather_tokens(ai, _argsort(noise)[:, :len_keep_for(g["La"], ratio)])
            vi = v[draws["perm_v"][off:off + b]]
            vi = gather_tokens(vi, _argsort(draws["chunk_v"][i])[
                :, :len_keep_for(g["Lv"], ratio)])
            pooled_a.append(self.final_norm(self.trunk(ai, "vit", "_a"),
                                            "vit.norm_a").mean(dim=1))
            pooled_v.append(self.final_norm(self.trunk(vi, "vit", "_v"),
                                            "vit.norm").mean(dim=1))
            off += b
        ca = torch.cat(pooled_a)[torch.argsort(draws["perm_a"])]
        cv = torch.cat(pooled_v)[torch.argsort(draws["perm_v"])]
        return info_nce(ca, cv, c["contrast_temp"])

    def mae(self, fbank, imgs, draws):
        """The MAE pass: (loss_mae, loss_mae_a, loss_mae_v)."""
        c, g = self.cfg, self.g
        ratio = c["mae_mask_ratio"]
        ka, kv = len_keep_for(g["La"], ratio), len_keep_for(g["Lv"], ratio)
        a, mask_a, ids_a = random_masking(self.embed_audio(fbank), ka,
                                          draws["noise_a"])
        v, mask_v, ids_v = random_masking(self.embed_video(imgs), kv,
                                          draws["noise_v"])
        vit = c["vit"]
        for i in range(vit["depth"]):
            v = self.block(v, f"vit.blocks.{i}", vit["num_heads"],
                           vit["block_ln_eps"], "_v")
            a = self.block(a, f"ast.blocks.{i}", vit["num_heads"],
                           vit["block_ln_eps"], "")
        x = torch.cat([self.final_norm(a, "ast.norm_a"),
                       self.final_norm(v, "vit.norm")], dim=1)
        x = self.linear(self.fusion(x), "decoder.embed")
        B, _, Dd = x.shape
        P = self.P

        def restore(kept, ids, total):
            filled = torch.cat([kept, P["decoder.mask_token"].expand(
                B, total - kept.shape[1], Dd)], dim=1)
            return gather_tokens(filled, ids)

        x = torch.cat([
            restore(x[:, :ka], ids_a, g["La"])
            + P["decoder.pos_embed_a"] + P["decoder.modality_a"],
            restore(x[:, ka:], ids_v, g["Lv"])
            + P["decoder.pos_embed_v"] + P["decoder.modality_v"]], dim=1)
        d = c["decoder"]
        for i in range(d["depth"]):
            x = self.block(x, f"decoder.blocks.{i}", d["num_heads"],
                           d["ln_eps"], "")
        x = self.norm(x, "decoder.norm", d["ln_eps"])
        pred_a = self.linear(x[:, :g["La"]], "decoder.pred_a")
        pred_v = self.linear(x[:, g["La"]:], "decoder.pred_v")
        loss_a = _mae_loss(pred_a, patchify(audio_image(fbank), g["p"]), mask_a)
        loss_v = _mae_loss(pred_v, patchify(imgs, g["p"]), mask_v)
        return loss_a + loss_v, loss_a, loss_v

    # ------------------------------------------------------------ finetune
    def finetune(self, fbank, frames):
        """The 'mm_grad' training forward: {'av': fused logits, 'a': audio
        logits, 'v': video logits}; ``frames`` [B, 1, 3, H, W]."""
        a = self.final_norm(self.trunk(self.embed_audio(fbank), "vit", "_a"),
                            "vit.norm_a")
        v = self.final_norm(self.trunk(self.embed_video(frames[:, 0]), "vit",
                                       "_v"), "vit.norm")
        x = self.fusion(torch.cat([a, v], dim=1))
        La = a.shape[1]
        fused = torch.cat([x[:, :La].mean(dim=1), x[:, La:].mean(dim=1)], -1)
        return {"av": self.head(fused, "mlp_head_mm"),
                "a": self.head(a.mean(dim=1), "mlp_head_a"),
                "v": self.head(v.mean(dim=1), "mlp_head")}

    def head(self, x, name):
        return self.linear(self.norm(x, f"{name}.ln", 1e-5), f"{name}.linear")


def _mae_loss(pred, target, mask):
    loss = ((pred - target) ** 2).mean(dim=-1)
    return (loss * mask).sum() / mask.sum()


def info_nce(a, v, temperature: float):
    """Bidirectional InfoNCE over L2-normalised embeddings: (loss, acc)."""
    a, v = F.normalize(a, dim=-1), F.normalize(v, dim=-1)
    logits = a @ v.T / temperature
    ids = torch.arange(logits.shape[0], device=logits.device)
    losses, accs = [], []
    for x in (logits, logits.T):
        losses.append(-torch.log_softmax(x, dim=0).diagonal().mean())
        accs.append((x.argmax(dim=0) == ids).float().mean())
    return (losses[0] + losses[1]) / 2, (accs[0] + accs[1]) / 2


def ce_soft(logits, targets):
    return -(targets * torch.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def bce(logits, targets):
    return F.binary_cross_entropy_with_logits(logits, targets)


# --------------------------------------------------- touched sets (pretrain)
_SHARED = re.compile(r"blocks\.\d+\.norm[12]\.")
_ROUTED = re.compile(r"blocks\.\d+\.norm[12]_[av]\.")
_PLAIN = re.compile(r"(^|\.)norm[12]\.")
_V = re.compile(r"(^|\.)norm[12]_v\.")


def touched_contrastive(name: str) -> bool:
    """Pass 1 steps the ``vit`` trunk but its blocks' shared norms."""
    return name.startswith("vit.") and not _SHARED.search(name)


def touched_mae(name: str) -> bool:
    """Pass 2 steps vit's embeddings, 'v' norms and final norm; ast's
    blocks with the shared norms and ast.norm_a; the fusion blocks' 'a'
    norms and weights; the decoder but its blocks' routed norms."""
    if name.startswith("vit."):
        if _SHARED.search(name) or _ROUTED.search(name):
            return bool(_V.search(name))
        return not name.startswith("vit.norm_a.")
    if name.startswith("ast."):
        if "patch_embed" in name or "pos_embed" in name or _ROUTED.search(name):
            return False
        return not name.startswith("ast.norm.")
    if name.startswith("mm_layer_"):
        return not (_PLAIN.search(name) or _V.search(name))
    if name.startswith("decoder."):
        return not _ROUTED.search(name)
    return False


def ft_rate(name: str, traffic: dict) -> float:
    """The finetune rate multiplier: heads ``head_lr``, fusion ``mm_lr``."""
    top = name.split(".", 1)[0]
    if top.startswith("mlp_head"):
        return traffic["head_lr"]
    if top.startswith("mm_layer"):
        return traffic["mm_lr"]
    return 1.0


# ------------------------------------------------------------------ Adam
class Adam:
    """torch.optim.Adam's update with L2 weight decay, per parameter;
    records the norm of each leaf's first gradient as Adam takes it
    (weight decay added) under ``tag:name`` (``pb_weights.parts``) in
    ``first``, and, in a step given a ``prefix``, each leaf's gradient in
    that step under ``prefix`` + ``tag:name`` in ``replay``."""

    def __init__(self, adam: dict, tag: str, first: Dict[str, float],
                 replay: Dict[str, float]):
        self.a, self.tag, self.first, self.replay = adam, tag, first, replay
        self.state: Dict[str, list] = {}

    @torch.no_grad()
    def step(self, P, names, grads, lr_of, prefix: Optional[str] = None
             ) -> None:
        a = self.a
        for name, g in zip(names, grads):
            p = P[name]
            g = (torch.zeros_like(p) if g is None else g) + a["weight_decay"] * p
            st = self.state.setdefault(name, [0, torch.zeros_like(p),
                                              torch.zeros_like(p)])
            if st[0] == 0:
                self.first.update(pb_weights.part_norms(f"{self.tag}:{name}",
                                                        g.reshape(-1)))
            if prefix is not None:
                self.replay.update(pb_weights.part_norms(
                    f"{prefix}{self.tag}:{name}", g.reshape(-1)))
            st[0] += 1
            st[1].mul_(a["b1"]).add_(g, alpha=1 - a["b1"])
            st[2].mul_(a["b2"]).addcmul_(g, g, value=1 - a["b2"])
            bc1 = 1 - a["b1"] ** st[0]
            bc2 = 1 - a["b2"] ** st[0]
            denom = (st[2].sqrt() / bc2 ** 0.5).add_(a["eps"])
            p.addcdiv_(st[1], denom, value=-lr_of(name) / bc1)


def _prefix(k: int, replay_steps) -> Optional[str]:
    return f"{k}:" if k in replay_steps else None


def pretrain_steps(cfg: dict, traffic: dict, P, batches, draws,
                   replay_steps=(), fp8: bool = False) -> dict:
    """The two-pass pretrain steps on ``batches`` [(fbank, frames)] with
    ``draws`` [(pass-1 draws, pass-2 draws)] (plain dicts of tensors),
    stepping ``P`` in place: {'losses': [loss_c, loss_mae per step],
    'first_grads': {opt:name: norm}, 'replay_grads': {k:opt:name: norm} of
    the steps k in ``replay_steps``}."""
    model = Model(cfg, P, fp8)
    first: Dict[str, float] = {}
    replay: Dict[str, float] = {}
    sets = [[n for n in P if touched_contrastive(n)],
            [n for n in P if touched_mae(n)]]
    opts = [Adam(traffic["adam"], "opt1", first, replay),
            Adam(traffic["adam"], "opt2", first, replay)]
    lr = traffic["lr"]
    losses = []
    with no_tf32():
        for i, ((fbank, frames), (d1, d2)) in enumerate(zip(batches, draws)):
            for k, (names, opt) in enumerate(zip(sets, opts)):
                for p in P.values():
                    p.requires_grad_(True)
                if k == 0:
                    loss, _ = model.contrastive(fbank, frames, d1)
                    loss = traffic["contrast_loss_weight"] * loss
                else:
                    loss = model.mae(fbank, frames, d2)[0]
                grads = torch.autograd.grad(loss, [P[n] for n in names],
                                            allow_unused=True)
                for p in P.values():
                    p.requires_grad_(False)
                opt.step(P, names, grads, lambda n: lr,
                         _prefix(i, replay_steps))
                losses.append(float(loss.detach()))
                del grads, loss
    return {"losses": losses, "first_grads": first, "replay_grads": replay}


def finetune_steps(cfg: dict, traffic: dict, P, batches, branches,
                   replay_steps=(), fp8: bool = False) -> dict:
    """'mm_grad' finetune steps on ``batches`` [(fbank, frames, targets)]
    with the loss of ``branches`` [branch] each; Adam steps only the
    parameters the loss reaches, at the group's rate: {'losses': [...],
    'first_grads': {opt:name: norm}, 'replay_grads': {k:opt:name: norm} of
    the steps k in ``replay_steps``}."""
    model = Model(cfg, P, fp8)
    first: Dict[str, float] = {}
    replay: Dict[str, float] = {}
    opt = Adam(traffic["adam"], "opt", first, replay)
    loss_fn = ce_soft if traffic["loss"] == "CE" else bce
    names = list(P)
    losses = []
    with no_tf32():
        for i, ((fbank, frames, y), branch) in enumerate(zip(batches,
                                                             branches)):
            for p in P.values():
                p.requires_grad_(True)
            loss = loss_fn(model.finetune(fbank, frames)[branch], y)
            grads = torch.autograd.grad(loss, [P[n] for n in names],
                                        allow_unused=True)
            for p in P.values():
                p.requires_grad_(False)
            reached = [(n, g) for n, g in zip(names, grads) if g is not None]
            opt.step(P, [n for n, _ in reached], [g for _, g in reached],
                     lambda n: traffic["lr"] * ft_rate(n, traffic),
                     _prefix(i, replay_steps))
            losses.append(float(loss.detach()))
            del grads, reached, loss
    return {"losses": losses, "first_grads": first, "replay_grads": replay}
