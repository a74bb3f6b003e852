"""The finetune job: the port's routed 'mm_grad' finetune step as CUDA
graphs, one a branch (``make_graphed_finetune_step``), with the gated
three-group Adam, on a ring of device-resident batches with soft targets.

The route of each step is the benchmark's, handed in as the draw u: in the
window, each block of ``len(traffic['route_block'])`` steps holds the
block's branches (the recipe's 0.5 / 0.25 / 0.25 as 2 'av', 1 'a', 1 'v')
in an order drawn from the seed, so every seed runs the same mix. Set-up
drives the one step object through ``traffic['compared']`` rounds of the
three branches in a seeded order (each branch's warm-up, which runs
eagerly, then its capture with its replay, then a replay), which the
reference follows; the last round's steps, each a replay that copies in a
new batch, are those whose gradients are compared as replays'.
"""

from __future__ import annotations

from typing import List

import torch

import pb_check
import pb_counts
import pb_job
import pb_reference
import pb_weights

BRANCHES = ("av", "a", "v")
# a draw u that routes to each branch: 'av' above 0.5, 'a' below 0.25
U = {"av": 0.75, "a": 0.125, "v": 0.375}


def targets(traffic: dict, gen: torch.Generator, n: int, device):
    """[n, classes] soft targets with the recipe's label smoothing: CE one
    class a clip, BCE each class on with probability 2 / classes."""
    c, ls = traffic["label_dim"], traffic["label_smooth"]
    if traffic["loss"] == "CE":
        hot = torch.nn.functional.one_hot(
            torch.randint(c, (n,), generator=gen, device=device), c).float()
    else:
        hot = (torch.rand((n, c), generator=gen, device=device) < 2.0 / c).float()
    return hot * (1.0 - ls) + ls / c


def route_blocks(traffic: dict, seed: int):
    """The window's branches, block after block, each block's order drawn
    from the seed."""
    gen = torch.Generator().manual_seed(
        pb_weights.chunk_seed(seed, pb_job.ROUTES))
    block = traffic["route_block"]
    while True:
        for i in torch.randperm(len(block), generator=gen).tolist():
            yield block[i]


def port_config(cfg: dict, traffic: dict):
    from avsiam_tpu_torch import configs as C
    model = C.CAVMAEFTConfig(
        vit=C.ViTConfig(**cfg["vit"]), label_dim=traffic["label_dim"],
        embed_double=cfg["embed_double"], dtype=getattr(torch, cfg["dtype"]),
        attn_impl=cfg["attn_impl"], mlp_impl=cfg["mlp_impl"],
        remat_blocks=cfg["remat_blocks"])
    return C.FinetuneConfig(
        model=model, opt=C.OptimizerConfig(lr=traffic["lr"], **traffic["adam"]),
        batch_size=traffic["batch"], head_lr=traffic["head_lr"],
        mm_lr=traffic["mm_lr"], ftmode="mm_grad", parity_optimizer=True,
        loss=traffic["loss"], label_smooth=traffic["label_smooth"])


class Job:
    """One run of the finetune job; ``graphed``, ``program`` as the
    pretrain job's."""

    kind = "finetune"
    first_losses = 3  # the losses ``loss_gap`` compares: each branch's eager first step

    def __init__(self, cell, seed: int, device="cuda", graphed: bool = True,
                 program: bool = True):
        t = cell.traffic
        self.cfg, self.traffic, self.seed, self.device = (
            cell.config, t, seed, device)
        self.batch = t["batch"]
        self.block = len(t["route_block"])
        self.profile_steps = t["profile_blocks"] * self.block
        self.spec = pb_reference.param_spec(self.cfg, "finetune", t["label_dim"])
        ring = pb_job.ring(self.cfg, t, seed, device, frames_dim=True)
        gen = pb_job.generator(seed, pb_job.DATA + 1, device)
        self.ring = [(a, v, targets(t, gen, a.shape[0], device))
                     for a, v in ring]
        order = torch.randperm(3, generator=torch.Generator().manual_seed(
            pb_weights.chunk_seed(seed, pb_job.ROUTES + 1))).tolist()
        self.compared = [(self.ring[k], BRANCHES[order[k % 3]])
                         for k in range(3 * t["compared"])]
        self.replay_steps = tuple(range(3 * t["compared"] - 3,
                                        3 * t["compared"]))
        self.routes = route_blocks(t, seed)
        self.branches: List[str] = []
        self.losses = []
        self.state = self.step_fn = None
        if program:
            from avsiam_tpu_torch.train import finetune as port
            self.port_cfg = port_config(self.cfg, t)
            gen = pb_job.generator(seed, 0, device)
            self.state = port.init_state(self.port_cfg, gen, device)
            self.params = pb_job.load_weights(self.state.model, self.spec, seed)
            self.step_fn = (port.make_graphed_finetune_step(self.port_cfg)
                            if graphed else port.make_finetune_step(self.port_cfg))

    # ------------------------------------------------------------ program
    def _call(self, batch, branch: str):
        _, metrics = self.step_fn(self.state, batch, self.traffic["lr"],
                                  u=U[branch])
        return metrics["loss"]

    def setup(self) -> None:
        """The compared steps: each loss, each leaf's first gradient from
        Adam's state after the step that first reached it, the replayed
        steps' gradients from the state across each, the change."""
        readings = {"losses": [], "first_grads": {}, "replay_grads": {}}
        opts = self.state.optimizers()
        b1 = self.traffic["adam"]["b1"]
        for k, (batch, branch) in enumerate(self.compared):
            before = (pb_job.adam_moments(opts) if k in self.replay_steps
                      else None)
            readings["losses"].append(float(self._call(batch, branch)))
            pb_job.first_grads(self.state.model, opts, b1,
                               readings["first_grads"])
            if before is not None:
                pb_job.step_grads(self.state.model, opts, b1, before,
                                  f"{k}:", readings["replay_grads"])
                del before
        readings["changes"] = pb_weights.change_norms(self.spec, self.seed,
                                                      self.params)
        self.readings = readings

    def step(self, i: int) -> None:
        batch = self.ring[(len(self.compared) + i) % len(self.ring)]
        branch = next(self.routes)
        self.branches.append(branch)
        self.losses.append(self._call(batch, branch))

    def failed(self) -> int:
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    def release(self) -> None:
        self.state = self.step_fn = self.params = None
        self.compared = [(tuple(x.clone() for x in b), br)
                         for b, br in self.compared]
        self.ring = []
        pb_job.free_cuda()

    # ---------------------------------------------------------- reference
    def reference(self, fp8: bool = False, half: bool = False) -> dict:
        """The reference's readings over the compared steps; ``fp8`` and
        ``half`` as the pretrain job's."""
        batches = [b for b, _ in self.compared]
        if half:
            h = self.batch // 2
            batches = [tuple(x[:h] for x in b) for b in batches]
        P = pb_weights.make(self.spec, self.seed, self.device)
        out = pb_reference.finetune_steps(
            self.cfg, self.traffic, P, batches,
            [br for _, br in self.compared], self.replay_steps, fp8=fp8)
        out["changes"] = pb_weights.change_norms(self.spec, self.seed, P)
        del P
        pb_job.free_cuda()
        return out

    def check(self) -> dict:
        """The numbers that decide ``correct``."""
        return pb_check.numbers(self.readings, self.reference(),
                                self.first_losses)

    # ------------------------------------------------------------- counts
    def model_flops(self, steps: int) -> float:
        return sum(pb_counts.finetune_model_flops(
            self.cfg, self.batch, self.traffic["label_dim"], br)
            for br in self.branches[:steps])

    def kernel_calls(self, steps) -> list:
        calls = []
        for i in steps:
            calls += pb_counts.finetune_kernel_calls(self.cfg, self.batch,
                                                     self.branches[i])
        return calls

    def clips(self, steps: int) -> int:
        return steps * self.batch
