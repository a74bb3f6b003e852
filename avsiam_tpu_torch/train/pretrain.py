"""The two-pass pretrain step of the port.

Counterpart of ``avsiam_tpu/train/pretrain.py:init_state`` and
``make_pretrain_step``. Per batch:

- pass 1: forward with (mae=0, contrast=1), backward, Adam #1 step over the
  contrastive pass's touched parameters;
- pass 2: forward of the parameters pass 1 just updated with (mae=1,
  contrast=0), backward, Adam #2 step over the MAE pass's touched set.

Gradients are cleared (``set_to_none``) before each pass, so no pass-1
gradient leaks into pass 2 for a parameter both passes touch. Parameters are
float32 masters updated in place; compute runs in ``cfg.model.dtype``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from avsiam_tpu_torch.configs import PretrainConfig
from avsiam_tpu_torch.models.cavmae import CAVMAEPretrain, MaskDraws
from avsiam_tpu_torch.train import param_groups as pg
from avsiam_tpu_torch.train.optim import (masked_torch_adam,
                                          multistep_lr_factor)


@dataclass
class PretrainState:
    model: CAVMAEPretrain
    opt1: torch.optim.Adam  # contrastive pass
    opt2: torch.optim.Adam  # MAE pass
    step: int = 0


def make_optimizers(model: CAVMAEPretrain, cfg: PretrainConfig):
    return (masked_torch_adam(model, cfg.opt, pg.touched_contrastive),
            masked_torch_adam(model, cfg.opt, pg.touched_mae))


def init_state(cfg: PretrainConfig, generator: Optional[torch.Generator] = None,
               device="cuda") -> PretrainState:
    """A freshly initialised model (from ``generator``) and its two Adams."""
    model = CAVMAEPretrain(cfg.model, device, generator)
    opt1, opt2 = make_optimizers(model, cfg)
    return PretrainState(model=model, opt1=opt1, opt2=opt2)


def _apply(opt: torch.optim.Adam, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = float(lr)
        for p in group["params"]:
            if p.grad is None:  # touched but unreached: a zero gradient, as
                p.grad = torch.zeros_like(p)  # the masked optax Adam sees it
    opt.step()


def make_pretrain_step(cfg: PretrainConfig):
    """Returns step(state, batch, generator, lr, draws=None) ->
    (state, metrics). ``batch`` is (fbank [B, T, F], frames [B, 3, H, W]);
    the masking draws of both passes come from ``generator`` unless
    ``draws`` gives them as (pass-1 MaskDraws, pass-2 MaskDraws)."""

    def step(state: PretrainState, batch, generator: Optional[torch.Generator],
             lr: float, draws: Optional[Tuple[MaskDraws, MaskDraws]] = None):
        a, v = batch
        model = state.model
        d1, d2 = draws if draws is not None else (None, None)

        def run_pass(opt, mae_w, contrast_w, d):
            model.zero_grad(set_to_none=True)
            out = model(a, v, cfg.masking_ratio_a, cfg.masking_ratio,
                        mae_loss_weight=mae_w, contrast_loss_weight=contrast_w,
                        mask_mode=cfg.mask_mode, draws=d, generator=generator)
            out[0].backward()
            _apply(opt, lr)
            return out

        out1 = run_pass(state.opt1, 0.0, 1.0, d1)  # contrastive only
        out2 = run_pass(state.opt2, 1.0, 0.0, d2)  # MAE only, updated params
        state.step += 1
        metrics = {
            "loss": out2[0].detach(),  # the reference's meters track pass 2
            "loss_c": out1[4].detach(),
            "c_acc": out1[7].detach(),
            "loss_mae": out2[1].detach(),
            "loss_mae_a": out2[2].detach(),
            "loss_mae_v": out2[3].detach(),
        }
        return state, metrics

    return step


def lr_for_epoch(cfg: PretrainConfig, epoch_1indexed: int) -> float:
    return cfg.opt.lr * multistep_lr_factor(
        epoch_1indexed, cfg.opt.lrscheduler_start, cfg.opt.lrscheduler_step,
        cfg.opt.lrscheduler_decay)
