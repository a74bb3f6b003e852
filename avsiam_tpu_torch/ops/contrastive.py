"""InfoNCE contrastive loss over [B, D] embeddings, and its global-batch
form across processes.

Counterpart of ``avsiam_tpu/ops/contrastive.py``: log-softmax over dim 0 of
``a @ v.T / temp``, the diagonal's mean, both directions averaged; accuracy is
the share of columns whose argmax over dim 0 is the diagonal.

Across processes the embeddings are gathered in rank order through
``GatherLayer`` (src/models/gather_layer.py:21-37), and every process
computes the same loss on the global batch. JAX writes the loss on the
logical global batch, where the transpose of the all-gather is a
reduce-scatter; here the backward sums the gathered gradient over the
processes (all-reduce) and takes this process's block, which is ``world``
times the global loss's gradient of that block, and the step's mean over
the processes' parameter gradients (``parallel.dist.all_reduce_mean_``)
brings it back to JAX's gradient. A backward that only sliced would leave
it ``world`` times too small.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12
                 ) -> torch.Tensor:
    """x / max(||x||, eps), as ``F.normalize``."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def info_nce(audio_rep: torch.Tensor, video_rep: torch.Tensor,
             temperature: float = 0.05, bidirect: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nce_loss, contrastive_accuracy), both float32 scalars."""
    a = l2_normalize(audio_rep.to(torch.float32))
    v = l2_normalize(video_rep.to(torch.float32))
    total = (a @ v.T) / temperature  # [B, B]
    diag_ids = torch.arange(total.shape[0], device=total.device)

    def _one_direction(logits):
        logp = torch.log_softmax(logits, dim=0)
        nce = -torch.mean(torch.diagonal(logp))
        acc = torch.mean((torch.argmax(logits, dim=0) == diag_ids)
                         .to(torch.float32))
        return nce, acc

    nce_1, acc_1 = _one_direction(total)
    if not bidirect:
        return nce_1, acc_1
    nce_2, acc_2 = _one_direction(total.T)
    return (nce_1 + nce_2) / 2.0, (acc_1 + acc_2) / 2.0


class GatherLayer(torch.autograd.Function):
    """[B_local, ...] on each process -> [world * B_local, ...] in rank
    order, differentiable: the backward all-reduces (sums) the gathered
    gradient, then takes this process's block."""

    @staticmethod
    def forward(ctx, x):
        world = dist.get_world_size()
        out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous())
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        n = grad.shape[0] // dist.get_world_size()
        r = dist.get_rank()
        return grad[r * n:(r + 1) * n]


def info_nce_gathered(audio_rep: torch.Tensor, video_rep: torch.Tensor,
                      temperature: float = 0.05, bidirect: bool = True,
                      gather: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """InfoNCE over the global batch. With ``gather`` (the [B_local, D]
    embeddings are one process's block of the global batch; a process
    group must be up) both are gathered through ``GatherLayer`` first, the
    counterpart of the JAX function's ``axis_name``; without it the batch
    is already the whole one."""
    if gather:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("a gathered InfoNCE needs a process group")
        audio_rep = GatherLayer.apply(audio_rep)
        video_rep = GatherLayer.apply(video_rep)
    return info_nce(audio_rep, video_rep, temperature, bidirect)
