"""Adam restricted to a pass's touched parameters, and the MultiStepLR factor.

Counterpart of ``avsiam_tpu/train/optim.py:masked_torch_adam`` and
``multistep_lr_factor``. torch.optim.Adam adds the L2 weight decay to the
gradient before the moment updates, which is what the JAX package builds
from ``optax.add_decayed_weights`` + ``scale_by_adam``. Restricting the
parameter list to the touched set gives ``optax.masked``'s semantics: the
other parameters get no moments, no decay and no step.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from avsiam_tpu_torch.configs import OptimizerConfig


def masked_torch_adam(model: nn.Module, cfg: OptimizerConfig,
                      predicate: Callable[[str], bool]) -> torch.optim.Adam:
    """Adam (betas (b1, b2), eps, weight decay) over the parameters whose
    name satisfies ``predicate``."""
    params = [p for name, p in model.named_parameters() if predicate(name)]
    return torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.b1, cfg.b2),
                            eps=cfg.eps, weight_decay=cfg.weight_decay)


def multistep_lr_factor(epoch_1indexed: int, start: int, step: int,
                        gamma: float) -> float:
    """MultiStepLR(milestones=range(start, 1000, step), gamma): the factor in
    effect during 1-indexed epoch e is gamma ** |{m : m <= e - 1}|."""
    milestones_passed = 0
    m = start
    while m <= epoch_1indexed - 1 and m < 1000:
        milestones_passed += 1
        m += step
    return gamma ** milestones_passed
