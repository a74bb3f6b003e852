"""The two-pass pretrain step of the port, and its validation forward.

Counterpart of ``avsiam_tpu/train/pretrain.py:init_state``,
``make_pretrain_step``, ``make_eval_step`` and ``lr_for_epoch``. Per batch:

- pass 1: forward with (mae=0, contrast=1), backward, Adam #1 step over the
  contrastive pass's touched parameters;
- pass 2: forward of the parameters pass 1 just updated with (mae=1,
  contrast=0), backward, Adam #2 step over the MAE pass's touched set.

Gradients are cleared (``set_to_none``) before each pass, so no pass-1
gradient leaks into pass 2 for a parameter both passes touch. Parameters are
float32 masters updated in place; compute runs in ``cfg.model.dtype``.

One body (``pretrain_step_body``) runs two ways: eagerly
(``make_pretrain_step``), and captured once into one CUDA graph and replayed
(``make_graphed_pretrain_step``), the counterpart of the JAX package's
``jax.jit(step)``. Both draw the passes' masks from the caller's generator
before the body, in the order the eager forwards draw them, so the two give
the same results from the same seed. ``step_generator`` gives the generator
of step n, keyed on (seed, n) as the JAX step keys its masks on
``fold_in(rng, state.step)``: a resumed run draws what the run it continues
would have drawn.

Data parallelism (under a process group, ``parallel/dist.py``): each
process holds the whole model and its block of the global batch. Every
process draws the global batch's masks from the same generator and its
forwards take its block of them (``MaskDraws.block``); the InfoNCE is the
global batch's (``ops/contrastive.py:GatherLayer``); after each backward
the gradients are averaged over the processes (flat buckets in a fixed
order, ``all_reduce_mean_``) before that pass's Adam, so the parameters
stay replicated; the step's metrics are the global ones, the same on every
process. The graphed step captures these collectives. Without a group
nothing of this runs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import torch

from avsiam_tpu_torch import kernels
from avsiam_tpu_torch.configs import CAVMAEConfig, PretrainConfig
from avsiam_tpu_torch.data.pipeline import batch_generator_seed
from avsiam_tpu_torch.models.cavmae import CAVMAEPretrain, MaskDraws, draw_masks
from avsiam_tpu_torch.parallel import dist as pdist
from avsiam_tpu_torch.train import param_groups as pg
from avsiam_tpu_torch.train.optim import (lr_tensor, masked_torch_adam,
                                          multistep_lr_factor)


@dataclass
class PretrainState:
    model: CAVMAEPretrain
    opt1: torch.optim.Adam  # contrastive pass
    opt2: torch.optim.Adam  # MAE pass
    step: int = 0

    @property
    def lr(self) -> torch.Tensor:
        """The 0-d learning-rate tensor both Adams read at their step."""
        return self.opt1.param_groups[0]["lr"]

    def optimizers(self) -> Dict[str, torch.optim.Adam]:
        return {"opt1": self.opt1, "opt2": self.opt2}


def make_optimizers(model: CAVMAEPretrain, cfg: PretrainConfig):
    """The two masked Adams, sharing one learning-rate tensor."""
    lr = lr_tensor(cfg.opt, next(model.parameters()).device)
    return (masked_torch_adam(model, cfg.opt, pg.touched_contrastive, lr),
            masked_torch_adam(model, cfg.opt, pg.touched_mae, lr))


def init_state(cfg: PretrainConfig, generator: Optional[torch.Generator] = None,
               device="cuda") -> PretrainState:
    """A freshly initialised model (from ``generator``) and its two Adams."""
    model = CAVMAEPretrain(cfg.model, device, generator)
    opt1, opt2 = make_optimizers(model, cfg)
    return PretrainState(model=model, opt1=opt1, opt2=opt2)


def draw_step_masks(cfg: CAVMAEConfig, batch: int, generator: torch.Generator,
                    device) -> Tuple[MaskDraws, MaskDraws]:
    """Both passes' draws from ``generator``, as the eager forwards would
    take them one after the other: pass 1 (contrastive) draws the batch
    permutations and chunk noise, pass 2 (MAE) the token noise."""
    if generator is None:
        raise ValueError("pass the step's draws or a generator")
    return (draw_masks(cfg, batch, generator, device, mae=False, contrast=True),
            draw_masks(cfg, batch, generator, device, mae=True, contrast=False))


def process_block(draws: Tuple[MaskDraws, MaskDraws], batch: int
                  ) -> Tuple[MaskDraws, MaskDraws]:
    """Under a process group, the global batch's draws with this process's
    block of rows, [rank * batch, (rank + 1) * batch), ``batch`` being the
    local batch; without one, the draws as they are."""
    if not pdist.active():
        return draws
    lo = pdist.rank() * batch
    return tuple(replace(d, block=(lo, lo + batch)) for d in draws)


# the pass-2 metrics that are per-process means under data parallelism
MAE_METRICS = ("loss", "loss_mae", "loss_mae_a", "loss_mae_v")


def _apply(opt: torch.optim.Adam, reduce: bool = False) -> None:
    """``opt``'s step, its touched parameters' gradients averaged over the
    processes first where ``reduce``."""
    grads = []
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:  # touched but unreached: a zero gradient, as
                p.grad = torch.zeros_like(p)  # the masked optax Adam sees it
            grads.append(p.grad)
    if reduce:
        pdist.all_reduce_mean_(grads)
    opt.step()


def pretrain_step_body(cfg: PretrainConfig, state: PretrainState,
                       a: torch.Tensor, v: torch.Tensor, draws1: MaskDraws,
                       draws2: MaskDraws) -> Dict[str, torch.Tensor]:
    """Both passes on the batch (a, v) with their draws, each Adam at the
    rate ``state.lr`` holds: the work of one step, with no host sync, which
    the graphed step captures. Returns the metrics as device tensors. Under
    a process group (a and v this process's block of the batch, the draws
    the global batch's with that block) the gradients are averaged over the
    processes before each Adam, and the metrics are the global batch's."""
    model = state.model
    dp = pdist.active()

    def run_pass(opt, mae_w, contrast_w, d):
        model.zero_grad(set_to_none=True)
        out = model(a, v, cfg.masking_ratio_a, cfg.masking_ratio,
                    mae_loss_weight=mae_w, contrast_loss_weight=contrast_w,
                    mask_mode=cfg.mask_mode, draws=d)
        out[0].backward()
        _apply(opt, dp)
        return out

    out1 = run_pass(state.opt1, 0.0, 1.0, draws1)  # contrastive only
    out2 = run_pass(state.opt2, 1.0, 0.0, draws2)  # MAE only, updated params
    metrics = {
        "loss": out2[0].detach(),  # the reference's meters track pass 2
        "loss_c": out1[4].detach(),
        "c_acc": out1[7].detach(),
        "loss_mae": out2[1].detach(),
        "loss_mae_a": out2[2].detach(),
        "loss_mae_v": out2[3].detach(),
    }
    if dp:
        # each process's MAE loss is the masked mean over its block, and
        # their mean over the processes is JAX's masked mean over the
        # global batch only because every sample masks the same number of
        # patches (len_keep_for at cfg.model.mae_mask_ratio), so every
        # block's mask sums to the same count; the same holds for the
        # gradient mean above. loss_c and c_acc are the global batch's
        mae = torch.stack([metrics[k] for k in MAE_METRICS])
        pdist.all_reduce_mean_([mae])
        metrics.update(zip(MAE_METRICS, mae.unbind()))
    return metrics


def make_pretrain_step(cfg: PretrainConfig):
    """Returns step(state, batch, generator, lr, draws=None) ->
    (state, metrics). ``batch`` is (fbank [B, T, F], frames [B, 3, H, W]);
    the masking draws of both passes come from ``generator`` unless
    ``draws`` gives them as (pass-1 MaskDraws, pass-2 MaskDraws). ``lr`` (a
    float or a 0-d tensor) is written into ``state.lr``. Under a process
    group ``batch`` is this process's block of the global batch, and the
    draws (drawn or given) are the global batch's."""

    def step(state: PretrainState, batch, generator: Optional[torch.Generator],
             lr, draws: Optional[Tuple[MaskDraws, MaskDraws]] = None):
        a, v = batch
        if draws is None:
            draws = draw_step_masks(cfg.model, a.shape[0] * pdist.world_size(),
                                    generator, a.device)
        draws = process_block(draws, a.shape[0])
        state.lr.fill_(lr)
        metrics = pretrain_step_body(cfg, state, a, v, *draws)
        state.step += 1
        return state, metrics

    return step


class _GraphedPretrainStep:
    """The pretrain step as one CUDA graph; see
    ``make_graphed_pretrain_step``."""

    def __init__(self, cfg: PretrainConfig):
        self.cfg = cfg
        self.state: Optional[PretrainState] = None
        self.a = self.v = None  # the static inputs, from the first call
        self.draws: Tuple[MaskDraws, MaskDraws] = ()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.metrics: Dict[str, torch.Tensor] = {}
        self.launches: Dict[str, int] = {}  # the kernels one replay launches
        self.failed: Optional[BaseException] = None

    def __call__(self, state: PretrainState, batch,
                 generator: Optional[torch.Generator], lr,
                 draws: Optional[Tuple[MaskDraws, MaskDraws]] = None):
        if self.failed is not None:
            raise RuntimeError("this graphed step failed to capture") \
                from self.failed
        first = self.state is None
        if first:
            self._bind(state, batch)
        elif state is not self.state:
            raise ValueError("a graphed step runs only the state of its "
                             "first call")
        for x, s, name in zip(batch, (self.a, self.v), ("fbank", "frames")):
            if (x.shape, x.dtype, x.device) != (s.shape, s.dtype, s.device):
                raise ValueError(
                    f"{name} {tuple(x.shape)} {x.dtype} on {x.device}: the "
                    f"step is captured for {tuple(s.shape)} {s.dtype} on "
                    f"{s.device}")
        d1, d2 = process_block(draws if draws is not None else draw_step_masks(
            self.cfg.model, self.a.shape[0] * pdist.world_size(), generator,
            self.a.device), self.a.shape[0])
        if first:
            self.draws = (d1.map(torch.clone), d2.map(torch.clone))
        else:
            self.draws[0].copy_(d1)
            self.draws[1].copy_(d2)
            self.a.copy_(batch[0])
            self.v.copy_(batch[1])
        state.lr.fill_(lr)
        if first:
            metrics = self._warm_up()
        else:
            if self.graph is None:
                self._capture()  # its launch counts stand for this replay
            else:
                kernels.add_launches(self.launches)
            self.graph.replay()
            metrics = self.metrics
        state.step += 1
        return state, {k: t.clone() for k, t in metrics.items()}

    def _bind(self, state: PretrainState, batch) -> None:
        """Take the state and static copies of the batch of the first
        call."""
        device = next(state.model.parameters()).device
        if device.type != "cuda":
            raise RuntimeError(
                f"the graphed pretrain step needs a CUDA device, not "
                f"{device}: use make_pretrain_step on the CPU")
        a, v = batch
        if a.shape[0] != v.shape[0] or {a.device, v.device} != {device}:
            raise ValueError(f"fbank {tuple(a.shape)} on {a.device} and "
                             f"frames {tuple(v.shape)} on {v.device} are no "
                             f"batch for a state on {device}")
        if pdist.world_size() > 1 and self.cfg.model.mmixed_impl != "padded":
            raise ValueError(
                f"mmixed_impl {self.cfg.model.mmixed_impl!r} over "
                f"{pdist.world_size()} processes: a process's share of each "
                f"chunk changes from step to step, which one graph cannot "
                f"hold; 'padded' has one shape (the eager step takes every "
                f"form)")
        self.state, self.a, self.v = state, a.clone(), v.clone()

    def _body(self):
        return pretrain_step_body(self.cfg, self.state, self.a, self.v,
                                  *self.draws)

    def _warm_up(self):
        """A real step of the body, eager, on a side stream (torch's
        whole-network capture recipe)."""
        current = torch.cuda.current_stream(self.a.device)
        side = torch.cuda.Stream(self.a.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            metrics = self._body()
        current.wait_stream(side)
        for t in metrics.values():
            t.record_stream(current)
        return metrics

    def _capture(self):
        """Capture the body once into the graph, in its private memory
        pool, with the eager blocks cached beside it released first, and
        keep the kernel launches the capture counted."""
        self.state.model.zero_grad(set_to_none=True)
        if pdist.active():
            # the communicator must exist before the capture starts: its
            # creation cannot be captured
            pdist.all_reduce_mean_([torch.zeros(1, device=self.a.device)])
        torch.cuda.synchronize(self.a.device)
        torch.cuda.empty_cache()
        before = dict(kernels.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        try:
            # thread-local: another thread may use the card meanwhile (the
            # data loader's worker pins batches and copies them on its own
            # stream); in the default global mode its calls would
            # invalidate the capture
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                metrics = self._body()
        except BaseException as err:
            self.failed = err
            raise RuntimeError("capturing the pretrain step in a CUDA graph "
                               "failed") from err
        self.launches = {k: kernels.LAUNCHES[k] - n for k, n in before.items()}
        self.graph, self.metrics = graph, metrics


def make_graphed_pretrain_step(cfg: PretrainConfig) -> _GraphedPretrainStep:
    """The pretrain step as one CUDA graph: a step with
    ``make_pretrain_step``'s signature and results, bound at its first call
    to that call's state and batch shapes.

    The first call is a real eager step of the body on a side stream: it
    creates Adam's state and cuBLAS's handles and loads the kernel library,
    which must all exist before a capture. The second call captures the
    body once (both passes' forward, backward and Adam) and replays it;
    later calls replay only. Before each replay the step copies the batch
    and both passes' draws (from ``generator`` unless ``draws`` gives them)
    into the static buffers it took from the first call, and writes ``lr``
    into ``state.lr``. Metrics come back as clones, which the next step
    does not overwrite. A replay adds the launch counts its capture counted
    to ``kernels.LAUNCHES``.

    No fallback: it raises on a state off the card, on another state than
    the first call's, on a batch of another shape, dtype or device, on
    draws of other shapes, and when the capture fails (then on every later
    call too). The routes the environment chooses, ``AVSIAM_LN``
    (``models/layers.py``) and ``AVSIAM_MLP_BWD`` (``ops/mlp.py``), are
    frozen at capture: a later change of either does not reach the
    graph. The capture is thread-local, so a data loader's worker thread
    may copy the next batch to the card while it runs
    (``data/pipeline.py:device_loader``), and so may NCCL's watchdog
    thread. Under a process group the capture holds the step's collectives
    (the gathers of the InfoNCE, the gradient and metric means); over more
    than one process it takes the 'padded' form only, whose shapes do not
    change from step to step."""
    return _GraphedPretrainStep(cfg)


def step_generator(seed: Optional[int], n: int, device) -> torch.Generator:
    """The generator of step n's draws, on ``device``. With a seed: seeded
    from (seed, n), the counterpart of ``jax.random.fold_in(PRNGKey(seed),
    n)`` with n the state's step count. Without one: seeded with n itself,
    the counterpart of ``PRNGKey(n)``, which keys the eval step's batch
    n."""
    gen = torch.Generator(device=device)
    return gen.manual_seed(int(n) if seed is None
                           else batch_generator_seed(seed, n))


def make_eval_step(cfg: PretrainConfig):
    """Returns eval_step(model, batch, generator, draws=None) -> metrics:
    the validation forward (traintest_cavmae_base.py:381-424), once, under
    ``torch.no_grad()``, with the config's loss weights
    (``cfg.mae_loss_weight``, ``cfg.contrast_loss_weight``) and the draws
    of ``draws`` or else from ``generator``. The metrics (loss, loss_mae,
    loss_mae_a, loss_mae_v, loss_c, c_acc) are device tensors. On the card
    the forward runs the step's forward kernels (K1 and K3 in the recipe's
    configuration)."""

    def eval_step(model: CAVMAEPretrain, batch,
                  generator: Optional[torch.Generator],
                  draws: Optional[MaskDraws] = None):
        a, v = batch
        with torch.no_grad():
            out = model(a, v, cfg.masking_ratio_a, cfg.masking_ratio,
                        mae_loss_weight=cfg.mae_loss_weight,
                        contrast_loss_weight=cfg.contrast_loss_weight,
                        mask_mode=cfg.mask_mode, draws=draws,
                        generator=generator)
        return {"loss": out[0], "loss_mae": out[1], "loss_mae_a": out[2],
                "loss_mae_v": out[3], "loss_c": out[4], "c_acc": out[7]}

    return eval_step


def lr_for_epoch(cfg: PretrainConfig, epoch_1indexed: int) -> float:
    return cfg.opt.lr * multistep_lr_factor(
        epoch_1indexed, cfg.opt.lrscheduler_start, cfg.opt.lrscheduler_step,
        cfg.opt.lrscheduler_decay)
