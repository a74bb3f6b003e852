"""InfoNCE contrastive loss over [B, D] embeddings.

Counterpart of ``avsiam_tpu/ops/contrastive.py``: log-softmax over dim 0 of
``a @ v.T / temp``, the diagonal's mean, both directions averaged; accuracy is
the share of columns whose argmax over dim 0 is the diagonal.
"""

from __future__ import annotations

from typing import Tuple

import torch


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


def info_nce_gathered(audio_rep: torch.Tensor, video_rep: torch.Tensor,
                      temperature: float = 0.05, bidirect: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """InfoNCE over the global batch. Single-process form: the batch here is
    already global (the cross-process gather comes with the distributed
    slice of the port)."""
    return info_nce(audio_rep, video_rep, temperature, bidirect)
