"""Data parallelism of the port (``parallel/``, the DP steps, loops, loader
and runner) held on the CPU over gloo: two processes against one, and
against the JAX package's global-batch steps.

One module fixture launches this file as a script (``_worker``): a world=1
worker under torchrun's environment (a process group of one) and a world=2
pair (the JAX-named flags: coordinator, process count and id), on
free ports, with a timeout that kills every rank. The workers import no
JAX; the fixture computes the JAX references meanwhile and hands them over
in a file the workers wait for. Geometry: ViT dim 128, 2 heads, depth 1
(the finetune model depth 2), float32 (``test_torch_port_common.py``).

Held:

- two pretrain steps in 'exact' and 'padded' at global batch 6 (3 a rank),
  from JAX's initial state (``params_from_jax``) and JAX's global draws
  split by rank: each rank's parameters and both Adams' moments after
  each step, and its first step's metrics, against JAX's
  ``make_pretrain_step`` at ``test_torch_port_step.py``'s tolerances; the
  two ranks the same bits; world=1 (a group of one) the same bits as the
  plain step in this process, with no group. world=2 against world=1:
  the first step's metrics within 1e-6 relative (the gradient mean and
  the gather reduce in another order), the second's within 1e-5, and
  parameters and moments under the step test's rules. Those rules, not a
  flat 1e-6, because an element whose gradient is rounding noise (the key
  bias, whose exact gradient is 0) moves by up to lr either way in Adam,
  whatever the order of the reduction; the second step's metrics are
  taken at parameters that carry that noise (in 'padded' the plain port's
  second-step loss_c is 2.3e-5 from JAX's, so they are held against
  world=1's);
- three gated 'mm_grad' finetune steps, one a branch, at global batch 4
  against JAX's gated Adam at ``test_torch_port_finetune.py``'s
  tolerances, the ranks the same bits;
- the gathered InfoNCE: each rank's raw block gradient is ``world`` times
  ``jax.grad`` of JAX's ``info_nce`` on the global batch, and a shared
  parameter's gradient, averaged over the ranks, is JAX's (1e-5);
- ``gather_eval_outputs`` keeps rank order and trims,
  ``average_across_processes`` averages, rank-0 printing prints forced
  lines on every rank and the rest on rank 0 alone (as
  ``tests/test_multiprocess.py``); a checkpoint rank 0 writes is read by
  both;
- the train loader under mixup: each rank's batches are its block of
  world=1's, bit for bit;
- the pretrain runner at world=2, its group made by the runner from the
  JAX-named flags (world=1's from torchrun's environment): its
  ``result.csv`` training columns
  within 1e-5 of world=1's and its final parameters the same bits on
  both ranks; rank 1 writes no file. The validation columns are each
  process's slab averaged, each batch i drawing from key i as in the JAX
  package's host-local validation, so they differ from world=1's by
  design: they are held finite.
"""

import csv
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, FT_B, LR = 6, 4, 1e-3
FORMS = ("exact", "padded")
WORKER_TIMEOUT = 300  # seconds, for the workers and the inputs they await


# ------------------------------------------------------------------ worker
def _tiny_index(prefix):
    """``{prefix}.json``, 8 clips over 3 classes, and its label CSV."""
    path, labels = f"{prefix}.json", f"{prefix}_labels.csv"
    with open(path, "w") as f:
        json.dump({"data": [{"wav": f"/fake/{i}.wav",
                             "labels": f"/m/{i % 3}"} for i in range(8)]}, f)
    with open(labels, "w") as f:
        f.write("index,mid,display_name\n0,/m/0,a\n1,/m/1,b\n2,/m/2,c\n")
    return path, labels


def _runner_argv(index, labels, exp_dir, *extra):
    return [*extra, "--data-train", index, "--data-val", index, "--label-csv",
            labels, "--n_class", "3", "--model", "tiny", "--n-epochs", "1",
            "--batch-size", "4", "--frame_source", "synthetic",
            "--max_steps_per_epoch", "2", "--exp-dir", exp_dir, "--dtype",
            "float32", "--target_length", "128", "--noise", "True",
            "--n-print-steps", "1"]


def _snapshot(state, opts):
    """Parameters and each Adam's moments (and step counts) by name."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    out = {"params": {n: p.detach().clone()
                      for n, p in state.model.named_parameters()}}
    for key, opt in opts.items():
        out[key] = {names[id(p)]: {k: st[k].clone() for k in
                                   ("exp_avg", "exp_avg_sq", "step")}
                    for p, st in opt.state.items()}
    return out


def _worker(out_dir, world, rank, port):
    """One rank: the parts that need no JAX, then, once the fixture has
    written ``inputs.pt``, the steps against it; results to
    ``result_w{world}_r{rank}.pt``."""
    os.environ["AVSIAM_PLATFORM"] = "cpu"
    from avsiam_tpu_torch.configs import AudioConfig
    from avsiam_tpu_torch.data.dataset import AVDataset, make_train_transform
    from avsiam_tpu_torch.data.pipeline import batch_generator_seed
    from avsiam_tpu_torch.models.cavmae import CAVMAEPretrain
    from avsiam_tpu_torch.models.variants import pretrain_config
    from avsiam_tpu_torch.ops.contrastive import info_nce_gathered
    from avsiam_tpu_torch.parallel import dist as pdist
    from avsiam_tpu_torch.train import finetune as ft
    from avsiam_tpu_torch.train import loops
    from avsiam_tpu_torch.train import pretrain as pt
    from avsiam_tpu_torch.utils import checkpoint as ck

    # first the pretrain runner, each rank given its own directory; its
    # ``mesh_from_args`` makes the group: world=1 from torchrun's
    # environment (a process group of one), world=2 from the JAX-named
    # flags
    from avsiam_tpu_torch.cli import pretrain as cli
    flags = []
    if world == 1:
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    else:
        flags = ["--coordinator_address", f"127.0.0.1:{port}",
                 "--num_processes", str(world), "--process_id", str(rank)]
    index, labels = _tiny_index(os.path.join(out_dir, f"idx_w{world}_r{rank}"))
    exp = os.path.join(out_dir, f"runner_w{world}_r{rank}")
    out = cli.main(_runner_argv(index, labels, exp, *flags))
    res = {"runner_params": {n: p.detach().clone()
                             for n, p in out["model"].named_parameters()}}

    info = pdist.initialize_multihost()  # the group is up: a no-op
    pdist.setup_rank0_printing()
    pdist.setup_rank0_printing()  # idempotent
    print(f"RANK0ONLY world={info['process_count']}")
    print(f"FORCED-rank{rank}", force=True)
    res.update(info=info, active=pdist.active())
    res["gathered"] = pdist.gather_eval_outputs(
        np.arange(6, dtype=np.float32).reshape(3, 2) + 100 * rank,
        total=3 * world - 1)
    res["averaged"] = pdist.average_across_processes(
        {"b": float(rank), "a": 2.0 * rank + 1.0})

    # a checkpoint rank 0 writes, read back by every rank
    model = CAVMAEPretrain(pretrain_config("tiny"), "cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0 if rank == 0 else -1.0)
    if rank == 0:
        ck.save_params(os.path.join(out_dir, "ck"), "shared", model)
    pdist.barrier()
    read = ck.restore_params(os.path.join(out_dir, "ck"), "shared")
    fresh = CAVMAEPretrain(pretrain_config("tiny"), "cpu").state_dict()
    res["ck_read_rank0s"] = all(torch.equal(read[k], fresh[k] + 1.0)
                                for k, _ in model.named_parameters())

    # the train loader under mixup: this rank's blocks of the batches
    audio = AudioConfig(target_length=128, num_mel_bins=32, mixup=0.5,
                        freqm=8, timem=16, noise=True)
    ds = AVDataset(index, audio, label_csv=labels, mode="train",
                   frame_source="synthetic", im_res=48, num_frames=3)
    loader = loops._epoch_loader(ds, 4, 1, 5, make_train_transform(
        audio, im_res=48), batch_generator_seed(5, 1), device="cpu")
    res["loader"] = [tuple(t.clone() for t in b) for b in loader]

    # the steps, from the fixture's JAX references
    inputs = os.path.join(out_dir, "inputs.pt")
    t0 = time.time()
    while not os.path.exists(inputs):
        if time.time() - t0 > WORKER_TIMEOUT:
            raise TimeoutError("no inputs.pt")
        time.sleep(0.2)
    inp = torch.load(inputs, weights_only=False)
    lo, hi = rank * B // world, (rank + 1) * B // world
    a, v = (t[lo:hi] for t in inp["batch"])
    res["pretrain"] = {}
    for form in FORMS:
        cfg = inp["pretrain_cfg"][form]
        state = pt.init_state(cfg, device="cpu")
        state.model.load_state_dict(inp["params0"], strict=True)
        step = pt.make_pretrain_step(cfg)
        steps = []
        for draws in inp["draws"][form]:
            state, m = step(state, (a, v), None, LR, draws=draws)
            steps.append(dict(metrics={k: x.clone() for k, x in m.items()},
                              **_snapshot(state, state.optimizers())))
        res["pretrain"][form] = steps

    fcfg = inp["ft_cfg"]
    fstate = ft.init_state(fcfg, torch.Generator().manual_seed(0), "cpu")
    fstate.model.load_state_dict(inp["ft_params0"], strict=True)
    fstep = ft.make_finetune_step(fcfg)
    flo, fhi = rank * FT_B // world, (rank + 1) * FT_B // world
    res["finetune"] = []
    for batch, u in zip(inp["ft_batches"], inp["ft_us"]):
        fstate, m = fstep(fstate, tuple(t[flo:fhi] for t in batch), inp[
            "ft_lr"], u)
        res["finetune"].append(dict(loss=m["loss"].clone(),
                                    **_snapshot(fstate, fstate.optimizers())))
    res["ft_branches"] = dict(fstate.branches)

    # the gathered InfoNCE: raw block gradients, and a shared parameter's
    # averaged gradient
    x, y, w = (inp["nce"][k] for k in ("x", "y", "w"))
    xa = x[lo:hi].clone().requires_grad_(True)
    ya = y[lo:hi].clone().requires_grad_(True)
    loss, acc = info_nce_gathered(xa, ya, temperature=0.05, gather=True)
    loss.backward()
    wp = w.clone().requires_grad_(True)
    loss_w, _ = info_nce_gathered(x[lo:hi] @ wp, y[lo:hi] @ wp,
                                  temperature=0.05, gather=True)
    loss_w.backward()
    pdist.all_reduce_mean_([wp.grad])
    res["nce"] = dict(loss=loss.detach(), acc=acc, gx=xa.grad, gy=ya.grad,
                      loss_w=loss_w.detach(), gw=wp.grad)
    pdist.barrier()
    torch.save(res, os.path.join(out_dir, f"result_w{world}_r{rank}.pt"))


# ------------------------------------------------------------------ fixture
def _free_port():
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _launch(out_dir, world, rank, port):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [REPO, os.path.join(REPO, "tests"),
                      os.environ.get("PYTHONPATH")])))
    env.pop("AVSIAM_PLATFORM", None)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), out_dir, str(world),
         str(rank), str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)


def _jax_references():
    """JAX's global-batch steps and draws, and the port's inputs for
    them."""
    import jax
    import jax.numpy as jnp

    import avsiam_tpu.train.pretrain as jpretrain
    from avsiam_tpu import configs as jc
    from avsiam_tpu.models import CAVMAEPretrain as JaxModel
    from avsiam_tpu.models.cavmae_ft import CAVMAEFinetune as JaxFT
    from avsiam_tpu.ops.contrastive import info_nce as jax_info_nce
    from avsiam_tpu.train import finetune as jft
    from avsiam_tpu_torch import configs as pc
    from avsiam_tpu_torch.utils.weights import params_from_jax
    from test_torch_port_common import batch, configs, draws_from
    from test_torch_port_finetune import _route_keys, ft_configs
    from test_torch_port_step import _fresh, _moments

    mp = pytest.MonkeyPatch()
    ref, inp = {"pretrain": {}}, {"draws": {}, "pretrain_cfg": {}}
    a, v = batch(B, seed=1)
    inp["batch"] = (torch.from_numpy(a), torch.from_numpy(v))
    state = None
    try:
        for form in FORMS:
            jcfg, pcfg = configs(batch=B, lr=LR)
            jcfg = jc.replace(jcfg, model=jc.replace(
                jcfg.model, attn_impl="xla", mlp_impl="dense",
                mmixed_impl=form))
            inp["pretrain_cfg"][form] = pc.replace(pcfg, model=pc.replace(
                pcfg.model, mmixed_impl=form))
            model = JaxModel(jcfg.model)
            if state is None:  # the forms share the initial state
                state = jax.device_get(jpretrain.init_state(
                    jax.random.PRNGKey(0), model, jcfg, (a, v)))
                inp["params0"] = params_from_jax(state.params)
            jstep = jpretrain.make_pretrain_step(model, jcfg)
            step_rng = jax.random.PRNGKey(11)
            draws, steps = [], []
            jstate = _fresh(state)
            # each pass's forward jitted once with its draws recorded (the
            # step's keys differ from step to step, the shapes do not)
            recorders = {w: _recorder(mp, model, *w)
                         for w in ((0.0, 1.0), (1.0, 0.0))}
            for s in range(2):
                k_mask1, k_perm1, k_mask2, k_perm2 = jax.random.split(
                    jax.random.fold_in(step_rng, s), 4)
                draws.append(tuple(
                    draws_from(jax.tree_util.tree_map(np.array, recorders[w](
                        state.params, a, v, {"mask": km, "perm": kp})),
                        *w, form)
                    for w, km, kp in (((0.0, 1.0), k_mask1, k_perm1),
                                      ((1.0, 0.0), k_mask2, k_perm2))))
                jstate, jm = jstep(jstate, (a, v), step_rng,
                                   jnp.float32(LR))
                steps.append(dict(
                    jax_metrics=jax.device_get(jm),
                    jax_params=params_from_jax(jax.device_get(
                        jstate.params)),
                    jax_opt=[_moments(o) for o in (jstate.opt1,
                                                   jstate.opt2)]))
            inp["draws"][form] = draws
            ref["pretrain"][form] = steps
    finally:
        mp.undo()

    # the gated 'mm_grad' finetune step, one branch a step
    jcfg, pcfg = ft_configs(parity_optimizer=True, kernels=False)
    inp["ft_cfg"], inp["ft_lr"] = pcfg, float(jcfg.opt.lr)
    rs = np.random.RandomState(7)
    vit = jcfg.model.vit
    ft_batches = []
    for _ in range(3):
        fb = rs.randn(FT_B, vit.audio_length, vit.mel_bins)
        fr = rs.randn(FT_B, 1, 3, vit.img_size, vit.img_size)
        y = (rs.rand(FT_B, jcfg.model.label_dim) < 0.3)
        ft_batches.append(tuple(np.asarray(t, np.float32)
                                for t in (fb, fr, y)))
    jmodel = JaxFT(jcfg.model)
    key, us = _route_keys()
    jstate = jft.init_state(jax.random.PRNGKey(0), jmodel, jcfg,
                            ft_batches[0])
    jparams = jax.device_get(jstate.params)
    jstep = jft.make_finetune_step(jmodel, jcfg)
    ref["finetune"] = []
    for fb in ft_batches:
        jstate, jm = jstep(jstate, fb, key, jnp.float32(jcfg.opt.lr))
        ref["finetune"].append((float(jm["loss"]), jax.device_get(jstate)))
    ref["ft_params0"] = jparams
    inp.update(ft_params0=params_from_jax(jparams), ft_us=us,
               ft_batches=[tuple(map(torch.from_numpy, fb))
                           for fb in ft_batches])

    # InfoNCE on the global batch: gradients of the embeddings and of a
    # shared projection
    rs = np.random.RandomState(3)
    x, y = (rs.randn(B, 16).astype(np.float32) for _ in range(2))
    w = rs.randn(16, 8).astype(np.float32)

    def loss_xy(x, y):
        return jax_info_nce(x, y, 0.05)[0]

    def loss_w(w):
        return jax_info_nce(x @ w, y @ w, 0.05)[0]

    gx, gy = jax.grad(loss_xy, argnums=(0, 1))(x, y)
    ref["nce"] = dict(loss=float(loss_xy(x, y)), gx=np.asarray(gx),
                      gy=np.asarray(gy), loss_w=float(loss_w(w)),
                      gw=np.asarray(jax.grad(loss_w)(w)))
    inp["nce"] = {k: torch.from_numpy(t) for k, t in
                  (("x", x), ("y", y), ("w", w))}
    return ref, inp


def _recorder(mp, model, mae_w, con_w):
    """The forward with these loss weights, jitted once, returning the
    draws it makes from its keys (``test_torch_port_common.record_draws``
    with the compile kept)."""
    import jax

    from test_torch_port_common import recording_draws

    def run(params, a, v, rngs):
        with recording_draws(mp) as rec:
            model.apply({"params": params}, a, v, mae_loss_weight=mae_w,
                        contrast_loss_weight=con_w, rngs=rngs)
        return rec

    return jax.jit(run)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("dp"))
    procs = [_launch(out_dir, 1, 0, _free_port())]
    port = _free_port()
    procs += [_launch(out_dir, 2, r, port) for r in range(2)]
    try:
        ref, inp = _jax_references()
        tmp = os.path.join(out_dir, "inputs.pt.tmp")
        torch.save(inp, tmp)
        os.replace(tmp, os.path.join(out_dir, "inputs.pt"))
        io = [p.communicate(timeout=WORKER_TIMEOUT) for p in procs]
    finally:
        # kill every rank: a rank left waiting on its peer would hold the
        # port and a core for the rest of the suite
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (so, se) in zip(procs, io):
        assert p.returncode == 0, f"worker failed:\n{so}\n{se[-6000:]}"
    results = {w: [torch.load(os.path.join(out_dir, f"result_w{w}_r{r}.pt"),
                              weights_only=False) for r in range(w)]
               for w in (1, 2)}
    return dict(ref=ref, inp=inp, res=results, out_dir=out_dir,
                stdout={1: [io[0][0]], 2: [io[1][0], io[2][0]]})


# ------------------------------------------------------------------- tests
def _max_rel(got, want):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).abs().max() / max(float(want.abs().max()),
                                                 1e-30))


def _tensors(tree, prefix=""):
    """Every tensor of a nested dict/list by a path name."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _tensors(t, f"{prefix}/{i}")


def _port_step(st):
    """A worker's step snapshot in ``test_torch_port_step.py``'s layout."""
    return dict(metrics=st["metrics"], params=st["params"],
                opt=[tuple({n: m[k] for n, m in st[o].items()}
                           for k in ("exp_avg", "exp_avg_sq"))
                     for o in ("opt1", "opt2")])


@pytest.mark.parametrize("s", [0, 1], ids=["step1", "step2"])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("rank", [0, 1])
def test_two_rank_pretrain_step_matches_jax(dp, form, s, rank):
    """Each rank of the world=2 step against JAX's global-batch step:
    parameters and both Adams' moments, and the first step's metrics, at
    ``test_torch_port_step.py``'s tolerances."""
    from test_torch_port_step import (_check_adam_moments, _check_metrics,
                                      _check_params)
    st = dict(dp["ref"]["pretrain"][form][s],
              **_port_step(dp["res"][2][rank]["pretrain"][form][s]))
    if s == 0:
        _check_metrics(st)
    _check_params(st, dp["inp"]["params0"], s)
    for opt in (0, 1):
        _check_adam_moments(st, s, opt)


@pytest.mark.parametrize("s", [0, 1], ids=["step1", "step2"])
@pytest.mark.parametrize("form", FORMS)
def test_ranks_identical_and_world2_near_world1(dp, form, s):
    """Both ranks hold the same bits in every metric, parameter and
    moment; world=2 against world=1: the metrics within 1e-6 relative at
    the first step and 1e-5 at the second, parameters and moments under
    ``test_torch_port_step.py``'s rules."""
    from test_torch_port_step import _check_adam_moments, _check_params
    r0, r1 = (dp["res"][2][r]["pretrain"][form][s] for r in (0, 1))
    for (n0, t0), (n1, t1) in zip(_tensors(r0), _tensors(r1), strict=True):
        assert n0 == n1 and torch.equal(t0, t1), n0
    w1 = _port_step(dp["res"][1][0]["pretrain"][form][s])
    tol = 1e-6 if s == 0 else 1e-5
    for k, want in w1["metrics"].items():
        assert _max_rel(r0["metrics"][k], want) <= tol, k
    st = dict(_port_step(r0), jax_params=w1["params"], jax_opt=w1["opt"])
    _check_params(st, dp["inp"]["params0"], s)
    for opt in (0, 1):
        _check_adam_moments(st, s, opt)


@pytest.mark.parametrize("form", FORMS)
def test_group_of_one_equals_the_plain_step(dp, form):
    """world=1 under torchrun's environment (every collective over one
    process) against the plain step in this process, with no group: the
    same bits."""
    from avsiam_tpu_torch.parallel import dist as pdist
    from avsiam_tpu_torch.train import pretrain as pt
    assert not pdist.active()
    inp = dp["inp"]
    cfg = inp["pretrain_cfg"][form]
    state = pt.init_state(cfg, device="cpu")
    state.model.load_state_dict(inp["params0"], strict=True)
    step = pt.make_pretrain_step(cfg)
    for draws, got in zip(inp["draws"][form],
                          dp["res"][1][0]["pretrain"][form]):
        state, m = step(state, inp["batch"], None, LR, draws=draws)
        for k, x in m.items():
            assert torch.equal(x, got["metrics"][k]), k
    for n, p in state.model.named_parameters():
        assert torch.equal(p, got["params"][n]), n


@pytest.mark.parametrize("s", [0, 1, 2])
def test_two_rank_gated_finetune_step_matches_jax(dp, s):
    """Step s (one 'mm_grad' branch a step) of each rank against JAX's
    gated Adam: the loss within 1e-5 relative, parameters and moments at
    ``test_torch_port_finetune.py``'s tolerances, every step count
    exactly; the ranks the same bits."""
    import jax

    from avsiam_tpu_torch.utils.weights import params_from_jax
    from test_torch_port_finetune import _check_moments, _check_params
    jloss, jstate = dp["ref"]["finetune"][s]
    r0, r1 = (dp["res"][2][r]["finetune"] for r in (0, 1))
    for (n0, t0), (n1, t1) in zip(_tensors(r0[s]), _tensors(r1[s]),
                                  strict=True):
        assert n0 == n1 and torch.equal(t0, t1), n0
    got = r0[s]
    assert abs(float(got["loss"]) - jloss) <= 1e-5 * abs(jloss)
    if s == 0:
        jbefore = dp["ref"]["ft_params0"]
        before = dp["inp"]["ft_params0"]
    else:
        jbefore = dp["ref"]["finetune"][s - 1][1].params
        before = r0[s - 1]["params"]
    assert _check_params(jstate.params, got["params"], jbefore, before) > 0
    zero = {"exp_avg": None, "exp_avg_sq": None, "step": torch.zeros(())}
    adam = {}
    for n, p in got["params"].items():
        st = got["opt"].get(n, zero)
        adam[n] = tuple(torch.zeros_like(p) if st[k] is None else st[k]
                        for k in ("exp_avg", "exp_avg_sq")) + (
            int(st["step"].item()),)
    _check_moments(jstate.opt.mu, jstate.opt.nu, adam)
    counts = params_from_jax(jax.device_get(jstate.opt.count))
    assert {n: c for n, (_, _, c) in adam.items()} == {
        n: int(c) for n, c in counts.items()}
    assert dp["res"][2][0]["ft_branches"] == {"av": 1, "a": 1, "v": 1}


def test_gathered_info_nce_gradient_matches_jax(dp):
    """GatherLayer's backward sums the gathered gradient over the ranks:
    each rank's raw block gradient is 2x JAX's gradient of the global
    loss for that block, and a shared projection's gradient averaged over
    the ranks is JAX's; the loss is the global batch's on every rank."""
    ref = dp["ref"]["nce"]
    for world in (1, 2):
        for rank, res in enumerate(dp["res"][world]):
            got = res["nce"]
            lo, hi = rank * B // world, (rank + 1) * B // world
            for k in ("loss", "loss_w"):
                assert abs(float(got[k]) - ref[k]) <= 1e-5 * abs(ref[k])
            for k in ("gx", "gy"):
                assert _max_rel(got[k] / world, ref[k][lo:hi]) <= 1e-5, k
            assert _max_rel(got["gw"], ref["gw"]) <= 1e-5


def test_dist_helpers_and_rank0_printing(dp):
    """``gather_eval_outputs`` concatenates the ranks' slabs in rank order
    and trims to the total; ``average_across_processes`` averages; forced
    prints appear on every rank and the rest on rank 0 alone; the world
    and the group (one process under torchrun's environment too)."""
    for world in (1, 2):
        expected = np.concatenate([
            np.arange(6, dtype=np.float32).reshape(3, 2) + 100 * r
            for r in range(world)])[:3 * world - 1]
        for rank, res in enumerate(dp["res"][world]):
            assert res["active"]
            assert res["info"]["process_count"] == world
            assert res["info"]["process_index"] == rank
            np.testing.assert_array_equal(res["gathered"], expected)
            want = {"a": 1.0 + (world - 1), "b": (world - 1) / 2}
            assert res["averaged"] == pytest.approx(want)
            out = dp["stdout"][world][rank]
            assert f"FORCED-rank{rank}" in out
            assert (f"RANK0ONLY world={world}" in out) == (rank == 0)
            assert (f"mesh: data={world} model=1 processes={world}"
                    in out) == (rank == 0)


def test_checkpoint_written_by_rank0_is_read_by_both(dp):
    assert all(res["ck_read_rank0s"] for res in dp["res"][2])


def test_loader_blocks_equal_world1_batches_under_mixup(dp):
    """With mixup 0.5 (partners anywhere in the global batch), SpecAugment
    and noise: rank r's batches are rows [2r, 2r+2) of world=1's, bit for
    bit."""
    full = dp["res"][1][0]["loader"]
    assert len(full) == 2
    for rank, res in enumerate(dp["res"][2]):
        assert len(res["loader"]) == len(full)
        for got, want in zip(res["loader"], full):
            for g, w in zip(got, want, strict=True):
                assert torch.equal(g, w[2 * rank:2 * rank + 2])


def _rows(path):
    with open(os.path.join(path, "result.csv"), newline="") as f:
        return list(csv.DictReader(f))


def test_two_rank_runner_matches_one(dp):
    """The pretrain runner at world=2 against world=1: the training columns
    of ``result.csv`` within 1e-5, the validation columns finite, the
    final parameters the same bits on both ranks and, after its two steps
    at lr 1e-4, within ``test_torch_port_step.py``'s Adam-noise rule of
    world=1's (every element within 2 lr a step, at most 0.5% beyond 1e-3
    lr + 1e-6); rank 1 wrote nothing, rank 0 what world=1 wrote."""
    out = dp["out_dir"]
    w1, w2 = (os.path.join(out, f"runner_w{w}_r0") for w in (1, 2))
    assert not os.path.exists(os.path.join(out, "runner_w2_r1"))

    def listing(path):
        return sorted(os.path.relpath(os.path.join(d, f), path)
                      for d, _, fs in os.walk(path) for f in fs)

    assert listing(w2) == listing(w1)
    (r1,), (r2,) = _rows(w1), _rows(w2)
    for k, want in r1.items():
        if k.startswith("eval_"):
            assert np.isfinite(float(r2[k])), k
        else:
            assert abs(float(r2[k]) - float(want)) <= 1e-5 * max(
                abs(float(want)), 1e-30), k
    p0, p1 = (dp["res"][2][r]["runner_params"] for r in (0, 1))
    single = dp["res"][1][0]["runner_params"]
    lr, n_loose, n_total = 1e-4, 0, 0
    for n, t in p0.items():
        assert torch.equal(t, p1[n]), n
        diff = (t - single[n]).abs()
        assert float(diff.max()) <= 2 * lr * 2 + 1e-6, n
        n_loose += int((diff > 1e-3 * lr + 1e-6).sum())
        n_total += diff.numel()
    assert n_loose <= 5e-3 * n_total, (n_loose, n_total)


# ---------------------------------------------------- in-process checks
def test_no_group_without_torchrun_or_process_flags(monkeypatch):
    """One process, no torchrun environment: ``initialize_multihost`` makes
    no group and describes a world of one; flags asking for more without a
    rendezvous are refused for the world mismatch."""
    from avsiam_tpu_torch.parallel import dist as pdist
    for k in pdist.TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)
    assert pdist.initialize_multihost() == {
        "process_index": 0, "process_count": 1, "local_devices": 1,
        "global_devices": 1}
    assert not pdist.active()
    with pytest.raises(SystemExit, match="does not match the world"):
        pdist.initialize_multihost(num_processes=2)
    with pytest.raises(SystemExit, match="outside the world"):
        pdist.initialize_multihost("127.0.0.1:1", 2, 5)
    assert not pdist.active()


def test_mesh_resolves_against_the_world():
    """The mesh's data axis is -1 or world / model, and its model axis
    must divide the world (a world of one takes 1); a global batch the
    data axis does not divide is refused in the JAX loop's words."""
    from avsiam_tpu_torch.configs import MeshConfig
    from avsiam_tpu_torch.parallel.mesh import Mesh, local_batch, make_mesh
    assert make_mesh(MeshConfig()) == Mesh(1, 1)
    assert make_mesh(MeshConfig(data=1)) == Mesh(1, 1)
    with pytest.raises(SystemExit, match="does not divide the world"):
        make_mesh(MeshConfig(model=2))
    with pytest.raises(SystemExit, match="does not match the world"):
        make_mesh(MeshConfig(data=4))
    assert local_batch(64, 4) == 16
    with pytest.raises(SystemExit, match="global batch 6 not divisible by "
                                         "mesh data axis 4"):
        local_batch(6, 4)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
            int(sys.argv[4]))
