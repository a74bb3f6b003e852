"""ToMe: token merging by bipartite soft matching, in static shapes.

Counterpart of ``avsiam_tpu/models/tome.py``. The tokens split into set A
(even positions) and set B (odd); each A token is matched to its most
similar B token by the cosine of the matching metric (the keys' mean over
the heads), and the r A tokens with the highest similarity merge into their
matches by a weighted average. As in the JAX package the shapes stay
static: the plan is an [B, N, N] assignment applied with one batched
matmul, the sequence keeps its N slots, and a ``keep`` mask marks the r
merged-away A slots (the reference's dynamic gather, which returns N - r
tokens, is not taken).

The sorts are stable and the argmax takes the first maximal index, as
``jnp.argsort`` and ``jnp.argmax`` do, so that tied similarities give the
JAX package's plan.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def bipartite_soft_matching(metric: torch.Tensor, r: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merge plan of ``metric`` [B, N, D] for r merges (at most
    ceil(N / 2), the size of A): (assign [B, N, N] in metric's dtype,
    assign[b, i, j] = 1 where token i goes to slot j, the identity but for
    the merged A tokens, which go to their B match; keep [B, N] bool, false
    at the merged A slots)."""
    B, N, _ = metric.shape
    dev = metric.device
    a_idx = torch.arange(0, N, 2, device=dev)
    b_idx = torch.arange(1, N, 2, device=dev)
    na = a_idx.shape[0]
    r = min(r, na)
    m = metric / metric.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    sim = m[:, a_idx] @ m[:, b_idx].transpose(1, 2)  # [B, Na, Nb]
    best_sim, best_match = sim.max(dim=-1)  # the first maximal index
    order = torch.argsort(-best_sim, dim=-1, stable=True)
    merge = torch.argsort(order, dim=-1, stable=True) < r  # [B, Na]
    flag = merge.to(metric.dtype)
    rows = a_idx.expand(B, na)
    bi = torch.arange(B, device=dev)[:, None].expand(B, na)
    assign = torch.eye(N, dtype=metric.dtype, device=dev).repeat(B, 1, 1)
    assign[bi, rows, rows] -= flag
    assign[bi, rows, b_idx[best_match]] += flag
    keep = torch.ones((B, N), dtype=torch.bool, device=dev)
    keep[:, a_idx] = ~merge
    return assign, keep


def merge_wavg(assign: torch.Tensor, x: torch.Tensor,
               size: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the plan: each slot the size-weighted mean of the tokens
    ``assign`` sends it. x [B, N, D]; size [B, N, 1] (None: ones in x's
    dtype, so that the merged x stays in x's dtype). Returns (merged x
    [B, N, D], the slots' sizes [B, N, 1]); a slot with keep false holds a
    stale value for the caller to mask."""
    if size is None:
        size = torch.ones((*x.shape[:2], 1), dtype=x.dtype, device=x.device)
    at = assign.to(x.dtype).transpose(1, 2)
    weighted = at @ (x * size)
    new_size = at @ size
    return weighted / new_size.clamp_min(1e-6), new_size
