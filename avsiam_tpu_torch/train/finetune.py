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
does; a caller may pass u (the tests hand the port JAX's draws). One body
(``finetune_step_body``) runs two ways: eagerly (``make_finetune_step``),
and captured into CUDA graphs and replayed, one graph a branch
(``make_graphed_finetune_step``, the counterpart of the JAX package's
``jax.jit(step)``); the eval forward likewise (``make_ft_eval_step``,
``make_graphed_ft_eval_step``).

Tracing (``utils/profiling.py``): every step call is an ``avsiam.step``
host span; the graphed step's also holds ``avsiam.step.inputs`` (the
checks, the route, the batch copies, ``set_lr``), ``avsiam.step.attach``
(``_attach``), ``avsiam.step.launch`` (the launch counts and the replay)
and ``avsiam.step.outputs`` (the loss's clone). Each branch's graph holds
the device marks ``start``, ``zero`` (the gradients zeroed), ``fwd`` (the
loss included), ``bwd``, under a process group ``reduce``, and ``adam``,
which ``phase_ms()`` reads.

Under a process group (``parallel/dist.py``) the batch is this process's
block of the global batch; u is drawn on the host and is the same on every
process, so every process backpropagates the same loss and reaches the
same parameters. The gradients that exist are averaged over the processes
(flat buckets in a fixed order) before Adam, and the loss is averaged: the
per-process means over equal blocks average to the global batch's mean.
The eval step has no collective. Under tensor parallelism the block and
the means are the data axis's (a model group's ranks step on the same
block), the model is sharded (``init_state``) and the step runs eagerly:
no graphed form holds the model group's collectives yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from avsiam_tpu_torch import kernels
from avsiam_tpu_torch.configs import FinetuneConfig
from avsiam_tpu_torch.models.cavmae_ft import CAVMAEFinetune
from avsiam_tpu_torch.parallel import dist as pdist
from avsiam_tpu_torch.parallel.tp import shard_model_
from avsiam_tpu_torch.train import graphs
from avsiam_tpu_torch.train import param_groups as pg
from avsiam_tpu_torch.train.optim import lr_tensor, multistep_lr_factor
from avsiam_tpu_torch.train.pretrain import step_generator
from avsiam_tpu_torch.utils import profiling

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


def gated(cfg: FinetuneConfig) -> bool:
    """Whether Adam skips the parameters the step's loss does not reach
    (the parity optimizer under 'mm_grad'); else it steps every one, the
    unreached ones on a zero gradient."""
    return cfg.parity_optimizer and cfg.ftmode == "mm_grad"


def step_branch(cfg: FinetuneConfig, step: int, u: Optional[float] = None
                ) -> Optional[str]:
    """Step ``step``'s loss branch under 'mm_grad': ``route(u)``, u the
    given draw or else ``draw_route(cfg.seed, step)``. None in every other
    mode, which draws nothing."""
    if cfg.ftmode != "mm_grad":
        return None
    return route(draw_route(cfg.seed, step) if u is None else u)


def finetune_step_body(cfg: FinetuneConfig, state: FinetuneState,
                       a: torch.Tensor, v: torch.Tensor, y: torch.Tensor,
                       branch: Optional[str] = None,
                       marks: Optional[profiling.PhaseMarks] = None
                       ) -> torch.Tensor:
    """The work of one step on the batch (a, v, y), the gradients as the
    caller left them: the forward, the loss of ``branch`` under 'mm_grad'
    (``cfg.ftmode``'s loss in every other mode) and its backward, a zero
    gradient for every parameter the loss did not reach unless
    ``gated``, under a process group the means of the gradients and the
    loss over the data group, and Adam at the rates the groups' tensors
    hold. No host sync, so the graphed step can capture it. Returns the
    loss, a device tensor. ``marks``: the branch graph's ``PhaseMarks``,
    marked after the loss, the backward, the means and Adam; None records
    nothing."""
    model = state.model
    loss_fn = loss_fn_for(cfg)
    mark = profiling.no_mark if marks is None else marks.mark
    if cfg.ftmode == "mm_grad":
        outs = dict(zip(BRANCHES, model(a, v, "mm_grad", False)))
        loss = loss_fn(outs[branch], y)
    else:
        loss = loss_fn(model(a, v, cfg.ftmode, False), y)
    mark("fwd")
    loss.backward()
    mark("bwd")
    if not gated(cfg):
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    loss = loss.detach()
    if pdist.active():
        # over the data group: a model group's ranks hold the same batch,
        # and each its shards' gradients
        group = pdist.data_group()
        pdist.all_reduce_mean_([p.grad for p in model.parameters()
                                if p.grad is not None], group)
        pdist.all_reduce_mean_([loss], group)
        mark("reduce")
    state.opt.step()
    mark("adam")
    return loss


def make_finetune_step(cfg: FinetuneConfig):
    """Returns step(state, batch, lr, u=None) -> (state, metrics), run
    eagerly. ``batch`` is (fbank [B, T, F], frames [B, 1, 3, H, W], labels
    [B, C]); ``lr`` (a float) times each group's multiplier is written into
    the groups' rate tensors; under 'mm_grad' the routing draw is ``u`` or
    else ``draw_route(cfg.seed, state.step)``. The gradients are cleared
    to None before ``finetune_step_body``. Metrics: the loss, a device
    tensor (the global batch's under a process group)."""

    def step(state: FinetuneState, batch, lr, u: Optional[float] = None):
        with profiling.annotate("avsiam.step"):
            state.set_lr(lr, cfg)
            state.model.zero_grad(set_to_none=True)
            branch = step_branch(cfg, state.step, u)
            loss = finetune_step_body(cfg, state, *batch, branch)
            if branch is not None:
                state.branches[branch] += 1
            state.step += 1
            return state, {"loss": loss}

    return step


class _GraphedFinetuneStep(graphs.Captures):
    """The finetune step as CUDA graphs, one a branch; see
    ``make_graphed_finetune_step``."""

    def __init__(self, cfg: FinetuneConfig, pool=None):
        super().__init__("the finetune step", pool)
        self.cfg = cfg
        self.state: Optional[FinetuneState] = None
        self.batch: Tuple[torch.Tensor, ...] = ()  # static, from call 1
        # every parameter's gradient and the loss, made before the first
        # capture, outside the pool: each branch's graph writes them
        self.grads: List[torch.Tensor] = []
        self.loss: Optional[torch.Tensor] = None
        # by branch (None outside 'mm_grad'): which parameters its warm-up
        # step gave a gradient, its graph, the kernels a replay launches
        self.touched: Dict[Optional[str], List[bool]] = {}
        self.graphs: Dict[Optional[str], torch.cuda.CUDAGraph] = {}
        self.launches: Dict[Optional[str], Dict[str, int]] = {}
        self.marks: Dict[Optional[str], profiling.PhaseMarks] = {}

    def __call__(self, state: FinetuneState, batch, lr,
                 u: Optional[float] = None):
        with profiling.annotate("avsiam.step"):
            return self._step(state, batch, lr, u)

    def _step(self, state, batch, lr, u):
        self.refuse_after_failure()
        first = self.state is None
        with profiling.annotate("avsiam.step.inputs"):
            if first:
                self._bind(state, batch)
            elif state is not self.state:
                raise ValueError("a graphed step runs only the state of its "
                                 "first call")
            for x, s, name in zip(batch, self.batch,
                                  ("fbank", "frames", "labels")):
                if (x.shape, x.dtype, x.device) != (s.shape, s.dtype,
                                                    s.device):
                    raise ValueError(
                        f"{name} {tuple(x.shape)} {x.dtype} on {x.device}: "
                        f"the step is captured for {tuple(s.shape)} "
                        f"{s.dtype} on {s.device}")
            branch = step_branch(self.cfg, state.step, u)
            if not first:
                for s, x in zip(self.batch, batch):
                    s.copy_(x)
            state.set_lr(lr, self.cfg)
        if branch not in self.touched:
            loss = self._warm_up(branch)
        else:
            captured = branch not in self.graphs
            if captured:
                self._capture(branch)  # its counts stand for this replay
            else:
                with profiling.annotate("avsiam.step.attach"):
                    self._attach(branch)
            with profiling.annotate("avsiam.step.launch"):
                if not captured:
                    kernels.add_launches(self.launches[branch])
                self.graphs[branch].replay()
            with profiling.annotate("avsiam.step.outputs"):
                loss = self.loss.clone()
        if branch is not None:
            state.branches[branch] += 1
        state.step += 1
        return state, {"loss": loss}

    def phase_ms(self) -> Dict[str, Dict[str, float]]:
        """{branch: {phase: device ms}} of each branch graph's last replay
        (``profiling.PhaseMarks``); the one graph outside 'mm_grad' is
        keyed 'step'."""
        return {"step" if b is None else b: self.marks[b].ms()
                for b in self.graphs}

    def _bind(self, state: FinetuneState, batch) -> None:
        """Take the state and static copies of the batch of the first
        call."""
        device = next(state.model.parameters()).device
        if device.type != "cuda":
            raise RuntimeError(
                f"the graphed finetune step needs a CUDA device, not "
                f"{device}: use make_finetune_step on the CPU")
        if len(batch) != 3 or {x.device for x in batch} != {device} or len(
                {x.shape[0] for x in batch}) != 1:
            raise ValueError(
                f"{[(tuple(x.shape), str(x.device)) for x in batch]}: no "
                f"(fbank, frames, labels) batch for a state on {device}")
        if pdist.model_size() > 1:
            raise ValueError(
                f"a model axis of {pdist.model_size()}: the tensor-parallel "
                f"step runs eagerly (make_finetune_step); no graphed form "
                f"holds its collectives yet")
        self.state = state
        self.batch = tuple(x.clone() for x in batch)

    def _body(self, branch, marks=None):
        return finetune_step_body(self.cfg, self.state, *self.batch, branch,
                                  marks)

    def _warm_up(self, branch) -> torch.Tensor:
        """The branch's first step: the body, eager, on a side stream, its
        gradients cleared to None first, as the eager step clears them;
        Adam's state for the parameters it reaches comes into being here.
        Keeps which parameters got a gradient."""
        self.state.model.zero_grad(set_to_none=True)
        loss = graphs.warm_up(lambda: self._body(branch),
                              self.batch[0].device)
        self.touched[branch] = [p.grad is not None
                                for p in self.state.model.parameters()]
        return loss

    def _attach(self, branch) -> None:
        """Give the parameters the branch's warm-up reached their kept
        gradient and the others None: what its capture records and, after
        each of its replays, what the eager step leaves in ``.grad``."""
        for p, g, t in zip(self.state.model.parameters(), self.grads,
                           self.touched[branch]):
            p.grad = g if t else None

    def _capture(self, branch) -> None:
        """Capture the branch's step into its graph in the shared pool,
        its gradients attached (``_attach``), so its backward writes (and
        its Adam steps) the same set as the eager step; its graph zeroes
        them before the backward."""
        device = self.batch[0].device
        if not self.grads:
            self.grads = [torch.zeros_like(p)
                          for p in self.state.model.parameters()]
            self.loss = torch.zeros((), dtype=torch.float32, device=device)
        live = [g for g, t in zip(self.grads, self.touched[branch]) if t]
        self._attach(branch)
        marks = self.marks[branch] = profiling.PhaseMarks(device)

        def body():
            marks.mark("start")
            torch._foreach_zero_(live)
            marks.mark("zero")
            self.loss.copy_(self._body(branch, marks))

        self.graphs[branch], _, self.launches[branch] = self.capture(
            body, device)


def make_graphed_finetune_step(cfg: FinetuneConfig, pool=None
                               ) -> _GraphedFinetuneStep:
    """The finetune step as CUDA graphs, the counterpart of the JAX
    package's ``jax.jit(step, donate_argnums=(0,))``: a step with
    ``make_finetune_step``'s signature and results, bound at its first call
    to that call's state and batch shapes. Under 'mm_grad' the routing draw
    is taken on the host (as the eager step takes it), so each branch
    ('av', 'a', 'v') has a graph of its own; every other mode has one.

    The first step of a branch is a real eager step of the body on a side
    stream (Adam's state for the parameters it reaches comes into being
    there, and the step shows which those are); its second captures the
    body and replays it; later steps replay only. All graphs share one
    memory pool (``pool``, a ``torch.cuda.graph_pool_handle`` shared with
    the eval forward, or None for one of their own), and every tensor that
    lives across replays stays outside it: the parameters, one gradient a
    parameter (attached to the parameters a branch reaches before its
    capture; None on the others), Adam's state, the static batch and loss.
    Before each replay the batch is copied into the static buffers and the
    rate into each group's tensor (``FinetuneState.set_lr``). A replay adds
    its capture's launch counts to ``kernels.LAUNCHES``; the loss comes
    back as a clone; after each call the parameters' ``.grad`` hold that
    step's gradients (None where it reached none), as after an eager
    step.

    Under ``gated`` a branch's graph steps only the parameters its loss
    reaches, and a parameter's step count advances only in the graphs of
    the branches that reach it, as the JAX package's gated Adam counts per
    leaf. Under a process group the gradient and loss means are captured
    (u is the same on every process, so each replays the same graph).

    No fallback: it raises on a state off the card, under a model axis (the
    tensor-parallel step runs eagerly), on another state than the first
    call's, on a batch of another shape, dtype or device, and when a
    capture fails (then on every later call too)."""
    return _GraphedFinetuneStep(cfg, pool)


def _eval_forward(model: CAVMAEFinetune, a, v, mode: str):
    with torch.no_grad():
        return model(a, v, mode, True)


def make_ft_eval_step(cfg: FinetuneConfig):
    """Returns eval_step(model, batch) -> logits: the eval-mode forward
    (traintest_ft_base.py:292-352) in ``cfg.ftmode_test`` or else
    ``cfg.ftmode``, eagerly, under ``torch.no_grad()``; ``batch`` is
    (fbank, frames [B, T, 3, H, W], labels). The sigmoid and the frame
    mean run on the host (``loops.validate_ft``)."""
    mode = cfg.ftmode_test or cfg.ftmode

    def eval_step(model: CAVMAEFinetune, batch):
        a, v, _ = batch
        return _eval_forward(model, a, v, mode)

    return eval_step


def make_graphed_ft_eval_step(cfg: FinetuneConfig, pool=None):
    """``make_ft_eval_step``'s eval step as CUDA graphs, the counterpart of
    the JAX package's ``jax.jit(eval_step)``
    (``train/graphs.py:GraphedForward``): bound to the model of its first
    call, which runs eagerly as the warm-up; one graph per batch
    signature; it raises for another model. ``pool``: a graph memory pool
    to share with the step, or None."""
    mode = cfg.ftmode_test or cfg.ftmode
    forward = graphs.GraphedForward(
        lambda model, a, v: _eval_forward(model, a, v, mode),
        "the finetune eval forward", pool)

    def eval_step(model: CAVMAEFinetune, batch):
        a, v, _ = batch
        return forward(model, a, v)

    eval_step.graphed = forward
    return eval_step


def lr_for_epoch(cfg: FinetuneConfig, epoch_1indexed: int) -> float:
    return cfg.opt.lr * multistep_lr_factor(
        epoch_1indexed, cfg.opt.lrscheduler_start, cfg.opt.lrscheduler_step,
        cfg.opt.lrscheduler_decay)
