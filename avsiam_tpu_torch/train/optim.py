"""Adam restricted to a pass's touched parameters, and the MultiStepLR factor.

Counterpart of ``avsiam_tpu/train/optim.py:masked_torch_adam`` and
``multistep_lr_factor``. torch.optim.Adam adds the L2 weight decay to the
gradient before the moment updates, which is what the JAX package builds
from ``optax.add_decayed_weights`` + ``scale_by_adam``. Restricting the
parameter list to the touched set gives ``optax.masked``'s semantics: the
other parameters get no moments, no decay and no step.

The port has one Adam form, fused and capturable, with the learning rate a
0-d float32 tensor on the parameters' device: the JAX step takes lr as a
traced argument (``avsiam_tpu/train/pretrain.py:52-56``), and a tensor
written with ``fill_`` between steps lets a captured CUDA graph of the step
follow the schedule without a new capture. Its step count and bias
corrections stay on the device.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from avsiam_tpu_torch.configs import OptimizerConfig


def lr_tensor(cfg: OptimizerConfig, device) -> torch.Tensor:
    """The learning rate as the 0-d float32 tensor ``masked_torch_adam``
    takes, set to ``cfg.lr``."""
    return torch.tensor(cfg.lr, dtype=torch.float32, device=device)


def masked_torch_adam(model: nn.Module, cfg: OptimizerConfig,
                      predicate: Callable[[str], bool],
                      lr: torch.Tensor) -> torch.optim.Adam:
    """Fused, capturable Adam (betas (b1, b2), eps, weight decay) over the
    parameters whose name satisfies ``predicate``. ``lr`` (``lr_tensor``) is
    the 0-d tensor its group reads at each step (shared, not copied:
    writing it with ``fill_`` sets the next step's rate)."""
    params = [p for name, p in model.named_parameters() if predicate(name)]
    return torch.optim.Adam(params, lr=lr, betas=(cfg.b1, cfg.b2),
                            eps=cfg.eps, weight_decay=cfg.weight_decay,
                            fused=True, capturable=True)


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
