"""The finetune step of the port: one Adam over three rate groups, with the
'mm_grad' mode's stochastic loss routing.

Counterpart of ``avsiam_tpu/train/finetune.py`` (``bce_with_logits``,
``ce_with_soft_targets``, ``group_lr_multipliers``, ``init_state``,
``make_finetune_step``, ``make_ft_eval_step``, ``lr_for_epoch``) and of
``avsiam_tpu/train/gated_adam.py`` (traintest_ft_base.py:78-83,106-157):

- one fused, capturable Adam with the groups 'base', 'mlp'
  (``mlp_head*``, rate x ``head_lr``) and 'mm' (``mm_layer*``, rate x
  ``mm_lr``), each reading its own 0-d learning-rate tensor
  (``optim.lr_tensor``); ``freeze_base`` gives 'base' the rate 0;
- 'mm_grad': one forward gives the fused, audio and video logits; a
  uniform draw u picks the loss, fused if u > 0.5, audio if u < 0.25,
  video otherwise, and only that loss is back-propagated;
- under 'mm_grad' with ``cfg.parity_optimizer`` the gradients are cleared
  to None before the backward, and torch's Adam skips a parameter whose
  gradient is None: a parameter outside the chosen loss's graph gets no
  moment decay, no weight decay and no step count, which is the JAX
  package's gated Adam (per-leaf step counts) without a gate tree. In
  every other case every parameter steps, the unreached ones on a zero
  gradient, as the JAX package's plain Adam does over every leaf.

Step n's u comes from a CPU generator keyed on (seed, n)
(``pretrain.step_generator``), so a resumed run routes as the straight run
does; a caller may pass u (the tests hand the port JAX's draws). The step
runs eagerly.

Under a process group (``parallel/dist.py``) the batch is this process's
block of the global batch; u is drawn on the host and is the same on every
process, so every process backpropagates the same loss and reaches the
same parameters. The gradients that exist are averaged over the processes
(flat buckets in a fixed order) before Adam, and the loss is averaged: the
per-process means over equal blocks average to the global batch's mean.
The eval step has no collective. Under tensor parallelism the block and
the means are the data axis's (a model group's ranks step on the same
block), the model is sharded (``init_state``) and the step runs eagerly,
as it always does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from avsiam_tpu_torch.configs import FinetuneConfig
from avsiam_tpu_torch.models.cavmae_ft import CAVMAEFinetune
from avsiam_tpu_torch.parallel import dist as pdist
from avsiam_tpu_torch.parallel.tp import shard_model_
from avsiam_tpu_torch.train import param_groups as pg
from avsiam_tpu_torch.train.optim import lr_tensor, multistep_lr_factor
from avsiam_tpu_torch.train.pretrain import step_generator

GROUPS = ("base", "mlp", "mm")
BRANCHES = ("av", "a", "v")


def bce_with_logits(logits, targets):
    """torch ``BCEWithLogitsLoss`` (mean) on float32 logits."""
    return F.binary_cross_entropy_with_logits(logits.float(), targets.float())


def ce_with_soft_targets(logits, targets):
    """torch ``CrossEntropyLoss`` with probability targets: the batch mean
    of -sum_k target_k log_softmax_k, in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(targets.float() * logp).sum(dim=-1).mean()


def loss_fn_for(cfg: FinetuneConfig):
    return bce_with_logits if cfg.loss == "BCE" else ce_with_soft_targets


def group_lr_multipliers(cfg: FinetuneConfig) -> Dict[str, float]:
    return {"base": 0.0 if cfg.freeze_base else 1.0, "mlp": cfg.head_lr,
            "mm": cfg.mm_lr}


def route(u: float) -> str:
    """The 'mm_grad' loss branch of the draw u (traintest_ft_base.py:
    149-157)."""
    if u > 0.5:
        return "av"
    return "a" if u < 0.25 else "v"


@dataclass
class FinetuneState:
    model: CAVMAEFinetune
    opt: torch.optim.Adam
    step: int = 0
    # steps taken per 'mm_grad' branch
    branches: Dict[str, int] = field(
        default_factory=lambda: dict.fromkeys(BRANCHES, 0))

    def optimizers(self) -> Dict[str, torch.optim.Adam]:
        return {"opt": self.opt}

    @property
    def lrs(self) -> Dict[str, torch.Tensor]:
        """Each group's 0-d learning-rate tensor, by group name."""
        return {g["name"]: g["lr"] for g in self.opt.param_groups}

    def set_lr(self, lr: float, cfg: FinetuneConfig) -> None:
        """Write ``lr`` times each group's multiplier into its tensor."""
        mults = group_lr_multipliers(cfg)
        for name, t in self.lrs.items():
            t.fill_(lr * mults[name])


def make_optimizer(model: CAVMAEFinetune, cfg: FinetuneConfig
                   ) -> torch.optim.Adam:
    """Fused, capturable Adam (betas, eps, L2 weight decay of ``cfg.opt``)
    over the groups 'base', 'mlp', 'mm', each with its own lr tensor set
    to ``cfg.opt.lr`` times its multiplier."""
    device = next(model.parameters()).device
    mults = group_lr_multipliers(cfg)
    groups = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        groups[pg.ft_group(name)].append(p)
    o = cfg.opt
    return torch.optim.Adam(
        [{"params": groups[g], "name": g,
          "lr": lr_tensor(o, device).mul_(mults[g])} for g in GROUPS],
        lr=lr_tensor(o, device), betas=(o.b1, o.b2), eps=o.eps,
        weight_decay=o.weight_decay, fused=True, capturable=True)


def init_state(cfg: FinetuneConfig, generator: Optional[torch.Generator] = None,
               device="cuda") -> FinetuneState:
    """A freshly initialised model (from ``generator``) and its Adam; under
    tensor parallelism the model is cut to this rank's shards first
    (``parallel/tp.py``; the Adam is elementwise, its per-parameter step
    counts too)."""
    model = shard_model_(CAVMAEFinetune(cfg.model, device, generator))
    return FinetuneState(model=model, opt=make_optimizer(model, cfg))


def draw_route(seed: int, step: int) -> float:
    """Step ``step``'s routing draw: a uniform from a CPU generator keyed on
    (seed, step)."""
    return float(torch.rand((), generator=step_generator(seed, step, "cpu")))


def make_finetune_step(cfg: FinetuneConfig):
    """Returns step(state, batch, lr, u=None) -> (state, metrics).
    ``batch`` is (fbank [B, T, F], frames [B, 1, 3, H, W], labels [B, C]);
    ``lr`` (a float) times each group's multiplier is written into the
    groups' rate tensors; under 'mm_grad' the routing draw is ``u`` or
    else ``draw_route(cfg.seed, state.step)``. Metrics: the loss, a device
    tensor (the global batch's under a process group)."""
    loss_fn = loss_fn_for(cfg)
    gated = cfg.parity_optimizer and cfg.ftmode == "mm_grad"
    dp = pdist.active()

    def step(state: FinetuneState, batch, lr, u: Optional[float] = None):
        a, v, y = batch
        model = state.model
        state.set_lr(lr, cfg)
        model.zero_grad(set_to_none=True)
        if cfg.ftmode == "mm_grad":
            if u is None:
                u = draw_route(cfg.seed, state.step)
            branch = route(u)
            outs = dict(zip(BRANCHES, model(a, v, "mm_grad", False)))
            loss = loss_fn(outs[branch], y)
            state.branches[branch] += 1
        else:
            loss = loss_fn(model(a, v, cfg.ftmode, False), y)
        loss.backward()
        if not gated:
            for p in model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        loss = loss.detach()
        if dp:
            # over the data group: a model group's ranks hold the same
            # batch, and each its shards' gradients
            group = pdist.data_group()
            pdist.all_reduce_mean_([p.grad for p in model.parameters()
                                    if p.grad is not None], group)
            pdist.all_reduce_mean_([loss], group)
        state.opt.step()
        state.step += 1
        return state, {"loss": loss}

    return step


def make_ft_eval_step(cfg: FinetuneConfig):
    """Returns eval_step(model, batch) -> logits: the eval-mode forward
    (traintest_ft_base.py:292-352) in ``cfg.ftmode_test`` or else
    ``cfg.ftmode``, under ``torch.no_grad()``; ``batch`` is (fbank, frames
    [B, T, 3, H, W], labels). The sigmoid and the frame mean run on the
    host (``loops.validate_ft``)."""
    mode = cfg.ftmode_test or cfg.ftmode

    def eval_step(model: CAVMAEFinetune, batch):
        a, v, _ = batch
        with torch.no_grad():
            return model(a, v, mode, True)

    return eval_step


def lr_for_epoch(cfg: FinetuneConfig, epoch_1indexed: int) -> float:
    return cfg.opt.lr * multistep_lr_factor(
        epoch_1indexed, cfg.opt.lrscheduler_start, cfg.opt.lrscheduler_step,
        cfg.opt.lrscheduler_decay)
