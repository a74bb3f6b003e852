"""Adam restricted to a pass's touched parameters, the MultiStepLR factor and
the plateau scheduler.

Counterpart of ``avsiam_tpu/train/optim.py:masked_torch_adam``,
``multistep_lr_factor``, ``PlateauScheduler`` and ``plateau_scheduler``.
torch.optim.Adam adds the L2 weight decay to the gradient before the moment
updates, which is what the JAX package builds from
``optax.add_decayed_weights`` + ``scale_by_adam``. Restricting the
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


class PlateauScheduler:
    """torch.optim.lr_scheduler.ReduceLROnPlateau's rule (the reference's
    ``lr_adapt`` path, traintest_cavmae_base.py:69-71: mode='max',
    factor=0.5, patience=args.lr_patience, everything else torch's
    defaults), as a host-side state machine over a rate, not over an
    optimizer: the pretrain step's two Adams share one lr tensor, which the
    loop writes with ``fill_``. ``step(metric)`` runs once per epoch after
    validation; the pretrain loop feeds it ``-eval_loss``
    (traintest_cavmae_base.py:236-237)."""

    def __init__(self, init_lr: float, mode: str = "max", factor: float = 0.5,
                 patience: int = 1, threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 0,
                 min_lr: float = 0.0, eps: float = 1e-8):
        if mode not in ("min", "max") or threshold_mode not in ("rel", "abs"):
            raise ValueError(f"mode {mode!r} or threshold_mode "
                             f"{threshold_mode!r} unknown")
        self.lr = float(init_lr)
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.threshold_mode = threshold, threshold_mode
        self.cooldown, self.min_lr, self.eps = cooldown, min_lr, eps
        self.best = float("-inf") if mode == "max" else float("inf")
        self.cooldown_counter = 0
        self.num_bad_epochs = 0

    def _is_better(self, a: float, best: float) -> bool:
        if self.mode == "min" and self.threshold_mode == "rel":
            return a < best * (1.0 - self.threshold)
        if self.mode == "min":
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best * (self.threshold + 1.0)
        return a > best + self.threshold

    def step(self, metric) -> float:
        current = float(metric)
        if self._is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0  # torch: cooldown suppresses bad epochs
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr


def plateau_scheduler(cfg: OptimizerConfig) -> PlateauScheduler:
    """The scheduler the reference's loops build under lr_adapt."""
    return PlateauScheduler(cfg.lr, mode="max", factor=0.5,
                            patience=cfg.lr_patience)
