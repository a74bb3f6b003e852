"""A run of each job on the CPU at the tiny preset, through the harness's
job functions with the program's eager step in place of its CUDA graphs
(the card's look and the timed window left out): the plain reference
follows the program within rounding in float32, a pretrain step and each
finetune branch; and with the cell's limits, ``correct`` comes out false
for the control (the reference in fp8 in the program's place) and for each
fault the cells can have, planted under the timed path: a step that
returns its state unchanged, half of each batch left out, and a step that
runs every call after its first on the batch of its first (as a graph
replay fed no new input would)."""

import math

import pytest
import torch

import tiny
import pb_check
import pb_harness as H

WORKLOADS = ("base-pretrain-b64", "base-ft-vggsound-b64", "base-ft-as20k-b4",
             "huge-pretrain-b64")
SEED = 2 ** 32 + 19


def rehearse(workload, plant=None, dtype="float32", **traffic):
    """Set-up's compared steps, window steps, then the check, as run.py
    runs them; ``plant(job)`` breaks the program's step first."""
    cell = tiny.cell(workload, dtype, **traffic)
    job = H.load_job(cell.traffic["job"]).Job(cell, SEED, device="cpu",
                                              graphed=False)
    if plant is not None:
        plant(job)
    job.setup()
    for i in range(2 * job.block):
        job.step(i)
    assert job.failed() == 0
    job.release()
    return job, cell


def unchanged(job):
    """The step computes its losses and leaves the state as it was."""
    real = job.step_fn

    def step(state, *args, **kw):
        model = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        opts = [(o, {p: {k: v.clone() for k, v in s.items()}
                     for p, s in o.state.items()})
                for o in state.optimizers().values()]
        out = real(state, *args, **kw)
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                p.copy_(model[n])
        for o, saved in opts:
            o.state.clear()
            o.state.update(saved)
        return out

    job.step_fn = step


def half_batch(job):
    """The step takes the first half of each batch and means over it."""
    real = job.step_fn
    gen = torch.Generator().manual_seed(5)

    def step(state, batch, *args, **kw):
        h = batch[0].shape[0] // 2
        if "draws" in kw:
            d1, d2 = H.load_job("pretrain").draws(job.cfg, h, gen, "cpu")
            from avsiam_tpu_torch.models.cavmae import MaskDraws
            kw["draws"] = (MaskDraws(perm_a=d1["perm_a"], perm_v=d1["perm_v"],
                                     chunk_a=d1["chunk_a"],
                                     chunk_v=d1["chunk_v"]), MaskDraws(**d2))
        return real(state, tuple(x[:h] for x in batch), *args, **kw)

    job.step_fn = step


def stale_batch(job):
    """Every call after a graph's first (a finetune branch's: its route
    draw ``u``) steps on that first call's batch."""
    real = job.step_fn
    first = {}

    def step(state, batch, *args, **kw):
        key = kw.get("u")
        if key not in first:
            first[key] = tuple(x.clone() for x in batch)
        return real(state, first[key], *args, **kw)

    job.step_fn = step


def follows(got):
    assert got["loss_gap"] < 1e-5 and got["replay_loss_gap"] < 1e-5, got
    assert got["grad_gap"] < 1e-4 and got["replay_grad_gap"] < 1e-4, got
    assert got["change_gap"] < 1e-3, got


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_follows_the_program(workload):
    job, cell = rehearse(workload)
    assert len(job.readings["replay_grads"]) >= 10
    assert {k.split(":", 1)[0] for k in job.readings["replay_grads"]} == {
        str(k) for k in job.replay_steps}
    got = job.check()
    follows(got)
    assert pb_check.verdict(got, cell.limits, cell.not_compared)["correct"]


@pytest.mark.parametrize("branch", ["av", "a", "v"])
def test_reference_follows_each_branch(branch):
    cell = tiny.cell("base-ft-vggsound-b64")
    job = H.load_job("finetune").Job(cell, SEED + 1, device="cpu",
                                     graphed=False)
    job.compared = [(b, branch) for b, _ in job.compared[:3]]
    job.setup()
    follows(pb_check.numbers(job.readings, job.reference(), job.first_losses))


@pytest.mark.parametrize("workload", WORKLOADS[:3])
def test_bf16_program_is_near(workload):
    job, _ = rehearse(workload, dtype="bfloat16")
    got = job.check()
    assert all(math.isfinite(v) for v in got.values())
    assert got["loss_gap"] < 1e-2, got


@pytest.mark.parametrize("workload", WORKLOADS[:3])
def test_control_is_not_correct(workload):
    job, cell = rehearse(workload)
    got = pb_check.numbers(job.reference(fp8=True), job.reference(),
                           job.first_losses)
    assert not pb_check.verdict(got, cell.limits,
                                cell.not_compared)["correct"], got


@pytest.mark.parametrize("fault", [unchanged, half_batch, stale_batch],
                         ids=["unchanged", "half_batch", "stale_batch"])
@pytest.mark.parametrize("workload", WORKLOADS[:3])
def test_fault_is_not_correct(workload, fault):
    job, cell = rehearse(workload, plant=fault)
    got = job.check()
    assert not pb_check.verdict(got, cell.limits,
                                cell.not_compared)["correct"], got
    if fault is unchanged:
        assert got["change_gap"] == pytest.approx(1.0)
    if fault is stale_batch:
        # the eager first step saw its own batch: the replays alone differ
        assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-4, got
        replay = [k for k in cell.limits if k.startswith("replay_")]
        assert replay and any(got[k] > cell.limits[k] for k in replay), got
