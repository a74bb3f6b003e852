"""The pretrain job: the port's two-pass pretrain step (contrastive pass,
then MAE pass, each with its masked Adam) as one CUDA graph,
``make_graphed_pretrain_step``, on a ring of device-resident batches,
each step's masking draws made by the benchmark and handed in.

Set-up builds the one step object and drives it through its first
``traffic['compared']`` steps on ring batches 0, 1, 2 (the warm-up, which
runs eagerly, the capture with its replay, a replay); the window goes on
with the same object from batch 3. The reference follows the compared
steps from the same weights, batches and draws; the last compared step,
a replay that copies in a new batch and new draws, is the one whose
gradients are compared as a replay's.
"""

from __future__ import annotations

import torch

import pb_check
import pb_counts
import pb_job
import pb_reference
import pb_weights


def draws(cfg: dict, batch: int, gen: torch.Generator, device) -> tuple:
    """One step's draws, in the order the step's forwards read them: pass
    1's batch permutations and each chunk's audio (base, r_t, r_f) and
    video uniforms, pass 2's token noise."""
    g = pb_counts.geometry(cfg)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)

    d1 = {"perm_a": torch.randperm(batch, generator=gen, device=device),
          "perm_v": torch.randperm(batch, generator=gen, device=device)}
    sizes = pb_counts.chunk_sizes(batch, cfg["mmixed_num_chunks"])
    d1["chunk_a"] = [(u(b, g["f"], g["t"]), u(b, g["t"]), u(b, g["f"]))
                     for b in sizes]
    d1["chunk_v"] = [u(b, g["Lv"]) for b in sizes]
    return d1, {"noise_a": u(batch, g["La"]), "noise_v": u(batch, g["Lv"])}


def port_config(cfg: dict, traffic: dict):
    from avsiam_tpu_torch import configs as C
    model = C.CAVMAEConfig(
        vit=C.ViTConfig(**cfg["vit"]), decoder=C.DecoderConfig(**cfg["decoder"]),
        embed_double=cfg["embed_double"], contrast_temp=cfg["contrast_temp"],
        mae_mask_ratio=cfg["mae_mask_ratio"],
        mmixed_num_chunks=cfg["mmixed_num_chunks"],
        mmixed_ratio_step=cfg["mmixed_ratio_step"],
        mmixed_impl=traffic["form"], dtype=getattr(torch, cfg["dtype"]),
        attn_impl=cfg["attn_impl"], mlp_impl=cfg["mlp_impl"],
        dec_mlp_impl=cfg["dec_mlp_impl"], remat_blocks=cfg["remat_blocks"])
    return C.PretrainConfig(
        model=model, opt=C.OptimizerConfig(lr=traffic["lr"], **traffic["adam"]),
        batch_size=traffic["batch"], masking_ratio=traffic["masking_ratio"],
        masking_ratio_a=traffic["masking_ratio_a"],
        contrast_loss_weight=traffic["contrast_loss_weight"],
        mae_loss_weight=traffic["mae_loss_weight"])


class Job:
    """One run of the pretrain job; ``graphed=False`` takes the eager step
    (the CPU rehearsal in the tests), ``program=False`` makes the inputs
    alone (the control)."""

    block = 1
    kind = "pretrain"
    first_losses = 2  # the losses ``loss_gap`` compares: the eager first step's two passes

    def __init__(self, cell, seed: int, device="cuda", graphed: bool = True,
                 program: bool = True):
        if cell.traffic["form"] != "exact":
            raise ValueError("the reference computes the 'exact' form only")
        self.cfg, self.traffic, self.seed, self.device = (
            cell.config, cell.traffic, seed, device)
        self.batch = cell.traffic["batch"]
        self.profile_steps = cell.traffic["profile_steps"]
        self.spec = pb_reference.param_spec(self.cfg, "pretrain")
        self.ring = pb_job.ring(self.cfg, cell.traffic, seed, device,
                                frames_dim=False)
        self.draw_gen = pb_job.generator(seed, pb_job.DRAWS, device)
        n = cell.traffic["compared"]
        self.compared = [(self.ring[k], draws(self.cfg, self.batch,
                                              self.draw_gen, device))
                         for k in range(n)]
        self.replay_steps = (n - 1,)
        self.losses = []
        self.state = self.step_fn = None
        if program:
            from avsiam_tpu_torch.train import pretrain as port
            self.port_cfg = port_config(self.cfg, self.traffic)
            gen = pb_job.generator(seed, 0, device)
            self.state = port.init_state(self.port_cfg, gen, device)
            self.params = pb_job.load_weights(self.state.model, self.spec, seed)
            self.step_fn = (port.make_graphed_pretrain_step(self.port_cfg)
                            if graphed else port.make_pretrain_step(self.port_cfg))

    # ------------------------------------------------------------ program
    def _call(self, batch, d):
        from avsiam_tpu_torch.models.cavmae import MaskDraws
        d1, d2 = d
        d1 = MaskDraws(perm_a=d1["perm_a"], perm_v=d1["perm_v"],
                       chunk_a=list(d1["chunk_a"]), chunk_v=list(d1["chunk_v"]))
        _, metrics = self.step_fn(self.state, batch, None, self.traffic["lr"],
                                  draws=(d1, MaskDraws(**d2)))
        return metrics

    def setup(self) -> None:
        """The compared steps through the window's own call: each step's
        losses, the first gradients from Adam's state after step 1, the
        replayed step's gradients from its state across that step, and the
        parameters' change after the last."""
        readings = {"losses": [], "first_grads": {}, "replay_grads": {}}
        opts = self.state.optimizers()
        b1 = self.traffic["adam"]["b1"]
        for k, (batch, d) in enumerate(self.compared):
            before = (pb_job.adam_moments(opts) if k in self.replay_steps
                      else None)
            m = self._call(batch, d)
            readings["losses"] += [float(m["loss_c"]), float(m["loss_mae"])]
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
        """Window step i: ring batch compared + i, fresh draws."""
        batch = self.ring[(len(self.compared) + i) % len(self.ring)]
        d = draws(self.cfg, self.batch, self.draw_gen, self.device)
        self.losses.append(self._call(batch, d)["loss"])

    def failed(self) -> int:
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    def release(self) -> None:
        """Free the program's state, its graph and the ring but the
        compared batches."""
        self.state = self.step_fn = self.params = None
        self.compared = [(tuple(x.clone() for x in b), d)
                         for b, d in self.compared]
        self.ring = []
        pb_job.free_cuda()

    # ---------------------------------------------------------- reference
    def reference(self, fp8: bool = False, half: bool = False) -> dict:
        """The reference's readings over the compared steps. ``fp8``: the
        lower-precision control; ``half``: a fault, the first half of each
        batch alone, with draws for that half."""
        batches = [b for b, _ in self.compared]
        ds = [d for _, d in self.compared]
        if half:
            h = self.batch // 2
            gen = pb_job.generator(self.seed, pb_job.DRAWS + 1, self.device)
            batches = [(a[:h], v[:h]) for a, v in batches]
            ds = [draws(self.cfg, h, gen, self.device) for _ in ds]
        P = pb_weights.make(self.spec, self.seed, self.device)
        out = pb_reference.pretrain_steps(self.cfg, self.traffic, P, batches,
                                          ds, self.replay_steps, fp8=fp8)
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
        return steps * pb_counts.pretrain_model_flops(self.cfg, self.batch)

    def kernel_calls(self, steps) -> list:
        return pb_counts.pretrain_kernel_calls(self.cfg, self.batch) * len(steps)

    def clips(self, steps: int) -> int:
        return steps * self.batch
