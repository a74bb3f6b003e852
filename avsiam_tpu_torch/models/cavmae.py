"""CAV-MAE pretraining model of the port: siamese audio-visual MAE plus the
multi-ratio contrastive encoder.

Counterpart of ``avsiam_tpu/models/cavmae.py:CAVMAEPretrain``. The forward
returns the same 8-tuple (loss, loss_mae, loss_mae_a, loss_mae_v, loss_c,
mask_a, mask_v, c_acc). Two encoder copies, ``vit`` and ``ast``: the MAE
branch runs audio through ``ast`` blocks with the shared norms and video
through ``vit`` blocks with the 'v' norms; the contrastive branch runs both
modalities through ``vit`` with 'a'/'v' routing.

Random draws are tensors (``MaskDraws``): the forward takes them explicitly,
or draws them from a caller's ``torch.Generator``. The multi-ratio
contrastive encoder takes every form of the JAX package (``mmixed_impl``):
'exact' (each chunk gathered to its own length and encoded alone),
'tconcat' (the chunks' rows in one array per modality, attention per
chunk), 'bucketed' (chunk lengths rounded up to 128, the tail masked),
'packed' (both modalities' rows in one array) and 'padded' (one full-length
encode per modality with per-sample keep masks, the config default). The
first four take the same draws; 'padded' draws its own. With
``remat_blocks`` the trunks' blocks are rematerialised in the backward.
``forward_feat`` and ``forward_inpaint`` are the feature and reconstruction
entry points.

Data parallelism: draws with a ``block`` are the global batch's, and the
forward computes that block of its rows (one process's). Every sample's
encoding depends on its own inputs and draws alone, so the block takes its
rows of the MAE noise and of the 'padded' keep masks, and of each chunk of
the chunked forms its members (``_block_chunks``); the InfoNCE gathers the
blocks' embeddings (``info_nce_gathered``) and is the global batch's.

The MAE decoder runs at its true length (La + Lv = 708 at ViT-B): the JAX
package pads it to 720 for the TPU's tiling, while the port's attention
kernel masks the ragged edge itself.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import torch
from torch import nn

from avsiam_tpu_torch.configs import CAVMAEConfig
from avsiam_tpu_torch.device import resolve_device
from avsiam_tpu_torch.models.layers import (Dense, LayerNormFP32,
                                            ModalityBlock, SiameseViT)
from avsiam_tpu_torch.ops import masking as mk
from avsiam_tpu_torch.ops.contrastive import info_nce_gathered
from avsiam_tpu_torch.ops.gather import take_batch, take_tokens
from avsiam_tpu_torch.ops.patchify import audio_to_image, patchify, unpatchify

MMIXED_IMPLS = ("exact", "tconcat", "bucketed", "packed", "padded")


def chunk_sizes(batch: int, num_chunks: int) -> list[int]:
    """torch.chunk semantics: ceil(B/n)-sized chunks, the last one smaller;
    empty chunks dropped."""
    size = -(-batch // num_chunks)
    sizes = []
    rem = batch
    while rem > 0:
        sizes.append(min(size, rem))
        rem -= size
    return sizes


@dataclass
class MaskDraws:
    """The random numbers of one forward.

    MAE branch: ``noise_a`` [B, La] and ``noise_v`` [B, Lv], the uniform
    noise whose argsort picks the kept tokens. Contrastive branch:
    ``perm_a``/``perm_v`` [B], the batch permutations cut into chunks; then
    in every form but 'padded' ``chunk_a[i]`` = (base [b_i, f, t], r_t
    [b_i, t], r_f [b_i, f]), the uniforms of chunk i's structured 'tf'
    audio noise, and ``chunk_v[i]`` [b_i, Lv], chunk i's video noise; in
    'padded' ``padded_a`` = (base [B, f, t], r_t [B, t], r_f [B, f]) and
    ``padded_v`` [B, Lv], the same uniforms over the whole batch in input
    order. ``block`` (lo, hi): these are a global batch's draws, of which
    the forward computes rows [lo, hi) (one process's under data
    parallelism); None: the batch is the whole one."""

    noise_a: Optional[torch.Tensor] = None
    noise_v: Optional[torch.Tensor] = None
    perm_a: Optional[torch.Tensor] = None
    perm_v: Optional[torch.Tensor] = None
    chunk_a: Optional[List[Tuple[torch.Tensor, torch.Tensor,
                                 torch.Tensor]]] = None
    chunk_v: Optional[List[torch.Tensor]] = None
    padded_a: Optional[Tuple[torch.Tensor, torch.Tensor,
                             torch.Tensor]] = None
    padded_v: Optional[torch.Tensor] = None
    block: Optional[Tuple[int, int]] = None

    def map(self, fn) -> "MaskDraws":
        """The draws with ``fn`` applied to every tensor."""
        def opt(t):
            return None if t is None else fn(t)

        return MaskDraws(
            noise_a=opt(self.noise_a), noise_v=opt(self.noise_v),
            perm_a=opt(self.perm_a), perm_v=opt(self.perm_v),
            chunk_a=None if self.chunk_a is None else [
                tuple(fn(t) for t in c) for c in self.chunk_a],
            chunk_v=None if self.chunk_v is None else [
                fn(t) for t in self.chunk_v],
            padded_a=None if self.padded_a is None else tuple(
                fn(t) for t in self.padded_a),
            padded_v=opt(self.padded_v), block=self.block)

    def tensors(self) -> List[Optional[torch.Tensor]]:
        """The single fields (None where not drawn), every chunk tensor in
        order, then the 'padded' fields (None where not drawn)."""
        return [self.noise_a, self.noise_v, self.perm_a, self.perm_v,
                *(t for c in self.chunk_a or () for t in c),
                *(self.chunk_v or ()),
                *(self.padded_a or (None,) * 3), self.padded_v]

    def copy_(self, src: "MaskDraws") -> "MaskDraws":
        """Copy ``src``'s draws into these tensors in place (the static
        buffers of a captured step). Raises, copying nothing, unless both
        hold the same fields at the same shapes and dtypes."""
        def layout(d):
            return [None if t is None else (t.shape, t.dtype)
                    for t in d.tensors()]

        if layout(self) != layout(src) or self.block != src.block:
            raise ValueError("the draws differ from the buffers in their "
                             "fields, chunks, shapes, dtypes or block")
        for t, s in zip(self.tensors(), src.tensors()):
            if t is not None:
                t.copy_(s)
        return self


def draw_masks(cfg: CAVMAEConfig, batch: int, generator: torch.Generator,
               device, mae: bool = True, contrast: bool = True) -> MaskDraws:
    """Draw a forward's random numbers from ``generator`` (on ``device``),
    in the layout of ``cfg.mmixed_impl`` and in the order the JAX forward
    reads them: the permutations, then per chunk the audio and the video
    noise, or in 'padded' base, r_t, r_f and the video noise over the
    batch (``avsiam_tpu/models/cavmae.py:482-497``)."""
    v = cfg.vit
    La, Lv = v.num_audio_tokens, v.num_video_tokens
    f, t = v.audio_grid

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)

    d = MaskDraws()
    if mae:
        d.noise_a, d.noise_v = uniform(batch, La), uniform(batch, Lv)
    if contrast:
        d.perm_a = torch.randperm(batch, generator=generator, device=device)
        d.perm_v = torch.randperm(batch, generator=generator, device=device)
        if cfg.mmixed_impl == "padded":
            d.padded_a = (uniform(batch, f, t), uniform(batch, t),
                          uniform(batch, f))
            d.padded_v = uniform(batch, Lv)
        else:
            sizes = chunk_sizes(batch, cfg.mmixed_num_chunks)
            d.chunk_a = [(uniform(b, f, t), uniform(b, t), uniform(b, f))
                         for b in sizes]
            d.chunk_v = [uniform(b, Lv) for b in sizes]
    return d


def padded_keep_masks(cfg: CAVMAEConfig, draws: MaskDraws
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, La] and [B, Lv] bool: the keep masks the 'padded' form draws
    from its draws (``ops.masking.padded_keep_masks``)."""
    B = draws.perm_a.shape[0]
    sizes = chunk_sizes(B, cfg.mmixed_num_chunks)
    f, t = cfg.vit.audio_grid
    return mk.padded_keep_masks(
        draws.perm_a, draws.perm_v, sizes[0],
        [cfg.mmixed_ratio_step * i for i in range(len(sizes))], f, t,
        *draws.padded_a, draws.padded_v)


def exact_keep_masks(cfg: CAVMAEConfig, draws: MaskDraws
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, La] and [B, Lv] bool: the tokens each sample keeps under the
    chunked forms' draws, at its input position. Given to the 'padded'
    encode (``CAVMAEPretrain._encode_contrastive``), they make it encode
    the same token sets as 'exact' (``tests/test_mmixed_equivalence.py``)."""
    f, t = cfg.vit.audio_grid
    La, Lv = cfg.vit.num_audio_tokens, cfg.vit.num_video_tokens
    B = draws.perm_a.shape[0]
    keep_a = torch.zeros((B, La), dtype=torch.bool, device=draws.perm_a.device)
    keep_v = torch.zeros((B, Lv), dtype=torch.bool, device=draws.perm_a.device)
    off = 0
    for i, size in enumerate(chunk_sizes(B, cfg.mmixed_num_chunks)):
        ratio = cfg.mmixed_ratio_step * i
        noise_a = mk.structured_noise(*draws.chunk_a[i], ratio)
        keep_a[draws.perm_a[off:off + size]] = mk.keep_mask(
            noise_a, mk.len_keep_for(La, ratio))
        keep_v[draws.perm_v[off:off + size]] = mk.keep_mask(
            draws.chunk_v[i], mk.len_keep_for(Lv, ratio))
        off += size
    return keep_a, keep_v


def _block_chunks(draws: MaskDraws) -> MaskDraws:
    """The chunked forms' draws of the rows [lo, hi) = ``draws.block`` of
    their global batch: of each chunk, per modality, the members in those
    rows, in chunk order, numbered from lo, with their noise rows. A chunk
    may keep no member of one modality or both. The local permutations
    are the members' concatenation. Reads the permutations on the host,
    unless the block is the whole batch (one process): then the draws as
    they are."""
    lo, hi = draws.block
    if hi - lo == draws.perm_a.shape[0]:
        return replace(draws, block=None)

    def pick(perm, chunks, rows_of):
        members, picked, off = [], [], 0
        for chunk in chunks:
            n = rows_of(chunk).shape[0]
            ids = perm[off:off + n]
            keep = torch.nonzero((ids >= lo) & (ids < hi)).squeeze(1)
            members.append(ids[keep] - lo)
            picked.append(tuple(t[keep] for t in chunk)
                          if isinstance(chunk, tuple) else chunk[keep])
            off += n
        return torch.cat(members), picked

    perm_a, chunk_a = pick(draws.perm_a, draws.chunk_a, lambda c: c[0])
    perm_v, chunk_v = pick(draws.perm_v, draws.chunk_v, lambda c: c)
    return MaskDraws(perm_a=perm_a, perm_v=perm_v, chunk_a=chunk_a,
                     chunk_v=chunk_v)


def _pool_chunk_rows(x: torch.Tensor, chunk_shapes) -> torch.Tensor:
    """Per-chunk mean over a [T, C] row concatenation of chunks [B_i, N_i,
    C]: [sum B_i, 1, C]."""
    parts, off = [], 0
    for b, n in chunk_shapes:
        parts.append(x[off:off + b * n].view(b, n, -1).mean(dim=1,
                                                             keepdim=True))
        off += b * n
    return torch.cat(parts)


def _prefix_valid(b: int, n: int, keep: int, device) -> Optional[torch.Tensor]:
    """[b, n] bool, True in each row's first ``keep`` positions; None where
    all n are kept."""
    if keep == n:
        return None
    return (torch.arange(n, device=device) < keep).repeat(b, 1)


class MAEDecoder(nn.Module):
    """MAE decoder: embed 768 -> 512, mask-token restore, zero-initialised
    trainable pos/modality embeddings, blocks with the shared norms, and
    per-modality prediction heads."""

    def __init__(self, cfg: CAVMAEConfig, device):
        super().__init__()
        c = cfg
        d = c.decoder
        p = c.vit.patch_size
        dt = c.dtype
        self.cfg = c
        self.embed = Dense(c.vit.dim, d.dim, dt, device)
        self.pos_embed_a = nn.Parameter(
            torch.zeros(1, c.vit.num_audio_tokens, d.dim, device=device))
        self.pos_embed_v = nn.Parameter(
            torch.zeros(1, c.vit.num_video_tokens, d.dim, device=device))
        self.mask_token = nn.Parameter(torch.zeros(1, 1, d.dim, device=device))
        self.modality_a = nn.Parameter(torch.zeros(1, 1, d.dim, device=device))
        self.modality_v = nn.Parameter(torch.zeros(1, 1, d.dim, device=device))
        dec_mlp = c.dec_mlp_impl or c.mlp_impl
        self.blocks = nn.ModuleList(
            ModalityBlock(d.dim, d.num_heads, d.mlp_ratio, True, d.ln_eps, dt,
                          c.attn_impl, c.vit.gelu, dec_mlp, device)
            for _ in range(d.depth))
        self.norm = LayerNormFP32(d.dim, d.ln_eps, dt, device)
        self.pred_a = Dense(d.dim, p * p * 1, dt, device)
        self.pred_v = Dense(d.dim, p * p * 3, dt, device)

    def forward(self, x, ids_restore_a, ids_restore_v, len_keep_a: int,
                len_keep_v: int):
        c = self.cfg
        La, Lv = c.vit.num_audio_tokens, c.vit.num_video_tokens
        x = self.embed(x)
        B, _, D = x.shape

        def restore(kept, ids_restore, total):
            mask_tokens = self.mask_token.to(kept.dtype).expand(
                B, total - kept.shape[1], D)
            return take_tokens(torch.cat([kept, mask_tokens], dim=1),
                               ids_restore)

        a_ = restore(x[:, :len_keep_a], ids_restore_a, La)
        v_ = restore(x[:, len_keep_a:], ids_restore_v, Lv)
        a_ = a_ + (self.pos_embed_a + self.modality_a).to(a_.dtype)
        v_ = v_ + (self.pos_embed_v + self.modality_v).to(v_.dtype)
        x = torch.cat([a_, v_], dim=1)
        for blk in self.blocks:
            x = blk(x, None)
        x = self.norm(x)
        return self.pred_a(x[:, :La]), self.pred_v(x[:, La:])


class CAVMAEPretrain(nn.Module):
    """The pretraining model. Parameters live on ``device`` ('cuda' by
    default; a missing card raises) and are initialised from ``generator``
    (a generator on that device seeded with 0 when None): lecun-normal dense
    kernels, zero biases, truncated-normal(0.02) encoder pos embeds, zero
    decoder pos embeds and tokens."""

    def __init__(self, cfg: CAVMAEConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        c = cfg
        if c.mmixed_impl not in MMIXED_IMPLS:
            raise ValueError(f"mmixed_impl {c.mmixed_impl!r} not in "
                             f"{MMIXED_IMPLS}")
        self.cfg = c
        mk_trunk = lambda: SiameseViT(c.vit, c.dtype, c.attn_impl,  # noqa: E731
                                      c.embed_double, c.mlp_impl, dev,
                                      c.remat_blocks)
        self.vit = mk_trunk()
        self.ast = mk_trunk()
        mk_block = lambda: ModalityBlock(  # noqa: E731
            c.vit.dim, c.vit.num_heads, c.vit.mlp_ratio, c.vit.qkv_bias,
            c.vit.block_ln_eps, c.dtype, c.attn_impl, c.vit.gelu, c.mlp_impl,
            dev)
        self.mm_layer_1 = mk_block()
        self.mm_layer_2 = mk_block()
        self.decoder = MAEDecoder(c, dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, (Dense, SiameseViT)):
                m.reset_parameters(generator)

    # -------------------------------------------------------- MAE encoder
    def forward_encoder(self, audio, imgs, mask_ratio_a: float,
                        mask_ratio_v: float, noise_a, noise_v):
        c = self.cfg
        a = self.vit.embed_audio(audio)
        v = self.vit.embed_video(imgs)
        len_keep_a = mk.len_keep_for(c.vit.num_audio_tokens, mask_ratio_a)
        len_keep_v = mk.len_keep_for(c.vit.num_video_tokens, mask_ratio_v)
        a, mask_a, ids_restore_a = mk.random_masking(a, len_keep_a, noise_a)
        v, mask_v, ids_restore_v = mk.random_masking(v, len_keep_v, noise_v)
        for i in range(c.vit.depth):
            v = self.vit.blocks[i](v, "v")
            a = self.ast.blocks[i](a, None)
        x = torch.cat([self.ast.norm_a(a), self.vit.norm(v)], dim=1)
        return x, mask_a, ids_restore_a, mask_v, ids_restore_v

    # ------------------------------------- multi-ratio contrastive encoder
    def forward_encoder_mmixed(self, audio, imgs, draws: MaskDraws):
        """Chunk i of the permuted batch is masked at ratio 0.2*i (structured
        'tf' for audio) and encoded in the form ``cfg.mmixed_impl`` names;
        returns the pooled outputs [B, 1, C] of each modality in input
        order (of the rows ``draws.block`` names, where it is set)."""
        c = self.cfg
        a = self.vit.embed_audio(audio)
        v = self.vit.embed_video(imgs)
        if c.mmixed_impl == "padded":
            keep_a, keep_v = padded_keep_masks(c, draws)
            if draws.block is not None:
                lo, hi = draws.block
                keep_a, keep_v = keep_a[lo:hi], keep_v[lo:hi]
            return (self._encode_contrastive(a, "a", keep_a),
                    self._encode_contrastive(v, "v", keep_v))
        if draws.block is not None:
            draws = _block_chunks(draws)
        ratios = [c.mmixed_ratio_step * i for i in range(len(draws.chunk_a))]
        chunks = self._masked_chunks(
            a, v, draws, ratios, 128 if c.mmixed_impl == "bucketed" else None)
        encode = getattr(self, f"_mmixed_{c.mmixed_impl}")
        ca, cv = encode(chunks)
        return (take_batch(ca, torch.argsort(draws.perm_a)),
                take_batch(cv, torch.argsort(draws.perm_v)))

    def _masked_chunks(self, a, v, draws: MaskDraws, ratios,
                       lane: Optional[int]):
        """Each chunk's gathered and masked audio and video [b_i, n_i, C]
        with their keep counts: [(a_i, keep_a, v_i, keep_v)], a_i or v_i
        None where the chunk has no member of that modality (a block's).
        The chunk sizes are the draws' rows. With ``lane`` each n_i is the
        keep count rounded up to a multiple of it, the tail rows inert
        (``random_masking``'s ``pad_to``)."""
        f, t = self.cfg.vit.audio_grid
        La, Lv = a.shape[1], v.shape[1]
        out, off_a, off_v = [], 0, 0
        for i, ratio in enumerate(ratios):
            keep_a = mk.len_keep_for(La, ratio)
            keep_v = mk.len_keep_for(Lv, ratio)
            pad_a = pad_v = None
            if lane:
                pad_a = -(-keep_a // lane) * lane
                pad_v = -(-keep_v // lane) * lane
            size_a, size_v = (draws.chunk_a[i][0].shape[0],
                              draws.chunk_v[i].shape[0])
            a_i = v_i = None
            if size_a:
                a_i = take_batch(a, draws.perm_a[off_a:off_a + size_a])
                a_i, _, _ = mk.random_masking_structured(
                    a_i, ratio, t, f, *draws.chunk_a[i], pad_to=pad_a)
            if size_v:
                v_i = take_batch(v, draws.perm_v[off_v:off_v + size_v])
                v_i, _, _ = mk.random_masking(v_i, keep_v, draws.chunk_v[i],
                                              pad_to=pad_v)
            out.append((a_i, keep_a, v_i, keep_v))
            off_a += size_a
            off_v += size_v
        return out

    def _encode_contrastive(self, x, modality: str,
                            key_valid: Optional[torch.Tensor] = None):
        """The trunk's blocks with ``modality``'s norms, its final norm and
        the mean over tokens (over the valid ones where ``key_valid`` [B, N]
        masks keys): [B, 1, C]."""
        x = self.vit.run_blocks(x, modality, key_valid)
        x = self.vit.final_norm(x, modality)
        if key_valid is None:
            return x.mean(dim=1, keepdim=True)
        return mk.masked_mean(x, key_valid)[:, None, :]

    def _mmixed_exact(self, chunks):
        """Each chunk encoded alone at its own length."""
        return self._encode_chunks(chunks, lambda x, keep: None)

    def _mmixed_bucketed(self, chunks):
        """'exact' at lengths rounded up to 128: the tail keys masked and
        left out of the pooling, no mask where a chunk needs no pad
        (``avsiam_tpu/models/cavmae.py:348-391``)."""
        return self._encode_chunks(chunks, lambda x, keep: _prefix_valid(
            x.shape[0], x.shape[1], keep, x.device))

    def _encode_chunks(self, chunks, valid):
        """Each chunk's audio, then its video, encoded alone under the key
        mask ``valid(x, keep count)``: the pooled outputs in chunk order."""
        a_parts, v_parts = [], []
        for a, keep_a, v, keep_v in chunks:
            if a is not None:
                a_parts.append(self._encode_contrastive(a, "a",
                                                        valid(a, keep_a)))
            if v is not None:
                v_parts.append(self._encode_contrastive(v, "v",
                                                        valid(v, keep_v)))
        return torch.cat(a_parts), torch.cat(v_parts)

    def _mmixed_tconcat(self, chunks):
        """Each modality's chunks as one [T, C] row array through the
        token-concat blocks (``avsiam_tpu/models/cavmae.py:303-346``): one
        GEMM per weight over all rows, attention per chunk."""
        def encode(parts, modality):
            shapes = [tuple(p.shape[:2]) for p in parts]
            x = torch.cat([p.reshape(-1, p.shape[-1]) for p in parts])
            x = self.vit.run_blocks_tconcat(x, modality, shapes)
            return _pool_chunk_rows(self.vit.final_norm(x, modality), shapes)

        return (encode([a for a, _, _, _ in chunks if a is not None], "a"),
                encode([v for _, _, v, _ in chunks if v is not None], "v"))

    def _mmixed_packed(self, chunks):
        """Both modalities' chunks as one [T, C] row array
        (``avsiam_tpu/models/cavmae.py:393-454``): the norms routed 'a'
        over the audio rows and 'v' over the video rows, the qkv and proj
        GEMMs and the MLP (``Mlp``, not the LN-folded sub-block) once over
        all rows, attention per chunk. The final norms are routed as
        ``norm_a`` and ``norm``."""
        parts_a = [a for a, _, _, _ in chunks if a is not None]
        parts = parts_a + [v for _, _, v, _ in chunks if v is not None]
        shapes = [tuple(p.shape[:2]) for p in parts]
        n_audio = sum(b * n for b, n in shapes[:len(parts_a)])
        x = torch.cat([p.reshape(-1, p.shape[-1]) for p in parts])

        def routed(x, norm_a, norm_v):
            return torch.cat([norm_a(x[:n_audio]), norm_v(x[n_audio:])])

        for blk in self.vit.blocks:
            qkv = blk.attn.qkv(routed(x, blk.norm1_a, blk.norm1_v))
            x = x + blk.attn.proj(blk.attn.attend_rows(qkv, shapes))
            x = x + blk.mlp(routed(x, blk.norm2_a, blk.norm2_v))
        pooled = _pool_chunk_rows(routed(x, self.vit.norm_a, self.vit.norm),
                                  shapes)
        n_a = sum(b for b, _ in shapes[:len(parts_a)])
        return pooled[:n_a], pooled[n_a:]

    # ------------------------------------------ features and inpainting
    def forward_feat(self, audio, imgs):
        """Unmasked token features of each modality through the ``vit``
        trunk with 'a'/'v' routing and its final norms: ([B, La, C],
        [B, Lv, C]) (``avsiam_tpu/models/cavmae.py:510-516``)."""
        a = self.vit.run_blocks(self.vit.embed_audio(audio), "a")
        v = self.vit.run_blocks(self.vit.embed_video(imgs), "v")
        return self.vit.norm_a(a), self.vit.norm(v)

    def forward_inpaint(self, audio, imgs, mask_ratio_a: float = 0.75,
                        mask_ratio_v: float = 0.75,
                        draws: Optional[MaskDraws] = None,
                        generator: Optional[torch.Generator] = None):
        """MAE reconstruction at the given ratios (``avsiam_tpu/models/
        cavmae.py:518-537``): (audio image [B, 1, F, T], frames [B, 3, H,
        W], mask_a [B, La], mask_v [B, Lv]), the predictions unpatchified.
        The token noise comes from ``draws`` (``noise_a``, ``noise_v``) or,
        when it is None, from ``generator``."""
        c = self.cfg
        if draws is None:
            if generator is None:
                raise ValueError("pass the draws or a generator")
            draws = draw_masks(c, audio.shape[0], generator, audio.device,
                               mae=True, contrast=False)
        x, mask_a, ids_ra, mask_v, ids_rv = self.forward_encoder(
            audio, imgs, mask_ratio_a, mask_ratio_v, draws.noise_a,
            draws.noise_v)
        x = self.mm_layer_2(self.mm_layer_1(x, "a"), "a")
        pred_a, pred_v = self.decoder(
            x, ids_ra, ids_rv,
            mk.len_keep_for(c.vit.num_audio_tokens, mask_ratio_a),
            mk.len_keep_for(c.vit.num_video_tokens, mask_ratio_v))
        f, t = c.vit.audio_grid
        gh, gw = c.vit.video_grid
        p = c.vit.patch_size
        return (unpatchify(pred_a, 1, f, t, p),
                unpatchify(pred_v, 3, gh, gw, p), mask_a, mask_v)

    # ------------------------------------------------------------ MAE loss
    def forward_mae_loss(self, inputs, pred, mask, modality: str):
        p = self.cfg.vit.patch_size
        img = audio_to_image(inputs) if modality == "a" else inputs
        target = patchify(img, p).to(torch.float32)
        loss = ((pred.to(torch.float32) - target) ** 2).mean(dim=-1)  # [N, L]
        return (loss * mask).sum() / mask.sum()

    # ------------------------------------------------------- full forward
    def forward(self, audio, imgs, mask_ratio_a: float = 0.75,
                mask_ratio_v: float = 0.75, mae_loss_weight: float = 1.0,
                contrast_loss_weight: float = 0.01,
                mask_mode: str = "unstructured",
                draws: Optional[MaskDraws] = None,
                generator: Optional[torch.Generator] = None):
        """The 8-tuple. The MAE branch masks at ``cfg.mae_mask_ratio``
        whatever the ratio arguments say, and the contrastive branch at its
        chunk ratios, as the reference does; the mask ratios and
        ``mask_mode`` are accepted for signature parity. Draws come from
        ``draws`` or, when it is None, from ``generator``."""
        c = self.cfg
        B = audio.shape[0]
        La, Lv = c.vit.num_audio_tokens, c.vit.num_video_tokens
        if draws is None:
            if generator is None:
                raise ValueError("pass the forward's draws or a generator")
            draws = draw_masks(c, B, generator, audio.device,
                               mae=mae_loss_weight != 0,
                               contrast=contrast_loss_weight != 0)
        zero = torch.zeros((), dtype=torch.float32, device=audio.device)
        noise_a, noise_v = draws.noise_a, draws.noise_v
        if draws.block is not None:
            lo, hi = draws.block
            if hi - lo != B:
                raise ValueError(f"draws for rows [{lo}, {hi}) of a batch "
                                 f"given {B} rows")
            if noise_a is not None:
                noise_a, noise_v = noise_a[lo:hi], noise_v[lo:hi]

        if mae_loss_weight != 0:
            x, mask_a, ids_ra, mask_v, ids_rv = self.forward_encoder(
                audio, imgs, c.mae_mask_ratio, c.mae_mask_ratio,
                noise_a, noise_v)
            x = self.mm_layer_1(x, "a")
            x = self.mm_layer_2(x, "a")
            pred_a, pred_v = self.decoder(
                x, ids_ra, ids_rv, mk.len_keep_for(La, c.mae_mask_ratio),
                mk.len_keep_for(Lv, c.mae_mask_ratio))
            loss_mae_a = self.forward_mae_loss(audio, pred_a, mask_a, "a")
            loss_mae_v = self.forward_mae_loss(imgs, pred_v, mask_v, "v")
            loss_mae = loss_mae_a + loss_mae_v  # unweighted, as the reference
        else:
            loss_mae_a = loss_mae_v = loss_mae = zero
            mask_a = torch.zeros((B, La), dtype=torch.float32,
                                 device=audio.device)
            mask_v = torch.zeros((B, Lv), dtype=torch.float32,
                                 device=audio.device)

        if contrast_loss_weight != 0:
            ca, cv = self.forward_encoder_mmixed(audio, imgs, draws)
            loss_c, c_acc = info_nce_gathered(
                ca.mean(dim=1), cv.mean(dim=1), temperature=c.contrast_temp,
                bidirect=True, gather=draws.block is not None)
            loss_c = contrast_loss_weight * loss_c
            # the reference overwrites the masks with the contrastive
            # encoder's returns, which are None
            mask_a = mask_v = None
        else:
            loss_c = c_acc = zero

        loss = loss_c + loss_mae
        return (loss, loss_mae, loss_mae_a, loss_mae_v, loss_c, mask_a,
                mask_v, c_acc)
