"""Tensor parallelism of the port (the mesh's 'model' axis: ``parallel/
mesh.py``, ``parallel/tp.py``, the sharded steps, loops, checkpoints and
runner) held on the CPU over gloo: against the JAX package's sharded steps
(``avsiam_tpu/train/loops.py:_shard_state`` on a 'model' axis, GSPMD) and
against the port's world of one.

One module fixture launches this file as a script (``_worker``) in three
worlds at once, on free ports, with a timeout that kills every rank: a
world of one (the runner, no group), a data 1 x model 2 pair and a data 2
x model 2 quartet (the JAX-named flags). The workers import no JAX; the
fixture computes JAX's sharded references meanwhile and hands them over in
a file the workers wait for. Geometry: ViT dim 128, 2 heads, depth 1;
decoder dim 128, 4 heads; the finetune model depth 2; float32
(``test_torch_port_common.py``); so each rank holds 1 ViT head and 2
decoder heads of D 64 and 32, and MLP hidden widths of 256.

Held:

(a) the port's rule table against ``avsiam_tpu.parallel.mesh.param_pspec``
    over every parameter of the pretrain and finetune models: the same
    parameters split, along the same dimension (nn.Linear's layout is the
    transpose of flax's kernel);
(b) ``shard_state_dict`` and ``gather_state_dict``: round trips bit for
    bit, each rank's qkv shard the q, k and v rows of its own heads;
(c) data 1 x model 2: two pretrain steps in 'exact' and 'padded' from
    JAX's initial parameters on JAX's draws, and three gated 'mm_grad'
    finetune steps (one a branch), against JAX's steps on a (1, 2) mesh:
    metrics, the gathered parameters and both Adams' moments at rtol 5e-4,
    atol 1e-5 (the JAX package's own TP tolerance,
    ``tests/test_sharded_contrastive.py``), but for the elements whose
    gradient is rounding noise, which ``test_torch_port_step.py``'s rule
    takes; every step count exactly; the replicated parameters the same
    bits on both ranks; and one step under each other MLP form ('dense',
    'fused', 'fbwd') against the port's world of one;
(d) data 2 x model 2: one pretrain step against JAX's (2, 2) mesh and the
    port's world of one (the subgroups, the InfoNCE gathered over the data
    group, the draws by data rank);
(e) the pretrain runner with ``--mesh_model 2``: ``result.csv`` against
    the world of one's, a resumed run against a straight one bit for bit,
    its ``train_state.1`` and ``best_audio_model`` loaded by a world of
    one;
(f) the refusals: heads or shard widths a model axis does not divide,
    data x model not the world;
(g) ToMe's matching metric under the model axis (a block with r > 0 at
    data 1 x model 2): each rank's keys summed over its heads and the
    model group, so that both ranks draw the plan of JAX's whole-width
    mean; the block's output and keep mask against JAX's.
"""

import csv
import os
import shutil
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
# the other MLP forms: (mlp_impl, AVSIAM_MLP_BWD), 'split' K8 and K9 twice
OTHER_MLP = (("dense", None), ("fused", None), ("fbwd", None),
             ("fused", "split"))
WORLDS = ((1, 1), (1, 2), (2, 2))  # (data, model)
WORKER_TIMEOUT = 300  # seconds, for the workers and the inputs they await
RTOL, ATOL = 5e-4, 1e-5
TOME_R = 8  # ToMe merges in the (1, 2) world's block
LOOSE = 1e-3  # of the elements, outside RTOL and ATOL (``_check_state``)


# ------------------------------------------------------------------ worker
def _snapshot(state):
    """The whole parameters, each Adam's whole moments and step counts by
    name (gathered over the model group: a collective), and this rank's
    replicated parameters."""
    from avsiam_tpu_torch.parallel.mesh import split_dim
    from avsiam_tpu_torch.parallel.tp import (full_optimizer_state,
                                              full_state_dict, param_names)
    names = {n for n, _ in state.model.named_parameters()}
    out = {"params": {n: t.clone() for n, t in
                      full_state_dict(state.model).items() if n in names},
           "replicated": {n: p.detach().clone() for n, p in
                          state.model.named_parameters()
                          if split_dim(n) is None}}
    for key, opt in state.optimizers().items():
        order = param_names(opt, state.model)
        out[key] = {order[i]: {k: st[k].clone() for k in
                               ("exp_avg", "exp_avg_sq", "step")}
                    for i, st in full_optimizer_state(
                        opt, state.model)["state"].items()}
    return out


def _runner(exp_dir, out_dir, flags, n_epochs, *extra):
    """The pretrain runner at the tiny preset for ``n_epochs`` epochs over
    ``flags`` (the world's); its final parameters, gathered."""
    from avsiam_tpu_torch.cli import pretrain as cli
    from avsiam_tpu_torch.parallel.tp import full_state_dict
    from test_torch_port_dist import _tiny_index
    index, labels = _tiny_index(os.path.join(out_dir, "idx"))
    out = cli.main([
        *flags, *extra, "--data-train", index, "--data-val", index,
        "--label-csv", labels, "--n_class", "3", "--model", "tiny",
        "--n-epochs", str(n_epochs), "--batch-size", "4", "--frame_source",
        "synthetic", "--max_steps_per_epoch", "2", "--exp-dir", exp_dir,
        "--dtype", "float32", "--target_length", "128", "--noise", "True",
        "--n-print-steps", "1"])
    return {n: t.clone() for n, t in full_state_dict(out["model"]).items()}


def _ft_runner(exp_dir, out_dir, flags):
    """The finetune runner at the tiny preset, two epochs of two steps,
    with the held-out eval and the checkpoint average, over ``flags``."""
    from avsiam_tpu_torch.cli import finetune as cli
    from test_torch_port_dist import _tiny_index
    index, labels = _tiny_index(os.path.join(out_dir, "ft_idx"))
    out = cli.main([
        *flags, "--data_train", index, "--data_val", index, "--data_eval",
        index, "--label_csv", labels, "--n_class", "3", "--model", "tiny",
        "--n_epochs", "2", "--batch_size", "4", "--frame_source",
        "synthetic", "--max_steps_per_epoch", "2", "--exp_dir", exp_dir,
        "--dtype", "float32", "--target_length", "128", "--wa", "True",
        "--wa_start", "1", "--wa_end", "2"])
    return {"wa_params": out["wa_params"],
            "eval_stats": [{k: np.asarray(v) for k, v in st.items()}
                           for st in out["eval_stats"]]}


def _tome_block(t, shard=True):
    """A ToMe block's output, keep mask and metric on ``t['x']`` from the
    full parameters ``t['params']``, the block cut to this rank's shards
    (``shard``) or whole."""
    from avsiam_tpu_torch.models.layers import ModalityBlock
    from avsiam_tpu_torch.parallel.tp import (load_full_state_dict,
                                              shard_model_)
    blk = ModalityBlock(128, 2, 4.0, True, 1e-5, torch.float32, "auto",
                        "erf", "dense", "cpu")
    if shard:
        shard_model_(blk)
    load_full_state_dict(blk, t["params"])
    with torch.no_grad():
        out, keep = blk(t["x"], "a", None, TOME_R)
        metric = blk.attn(blk.norm1_a(t["x"]), tome=True)[1]
    return dict(out=out, keep=keep, metric=metric,
                heads=blk.attn.num_heads)


def _worker(out_dir, data, model, rank, port):
    """One rank of a data x model world: its parts, then, once the fixture
    has written ``inputs.pt``, the steps against it; results to
    ``result_{data}x{model}_r{rank}.pt``."""
    os.environ["AVSIAM_PLATFORM"] = "cpu"
    from avsiam_tpu_torch.configs import MeshConfig
    from avsiam_tpu_torch.parallel import dist as pdist
    from avsiam_tpu_torch.parallel.mesh import make_mesh
    from avsiam_tpu_torch.parallel.tp import load_full_state_dict
    from avsiam_tpu_torch.train import finetune as ft
    from avsiam_tpu_torch.train import pretrain as pt

    world = data * model
    tag = f"{data}x{model}"
    flags = [] if world == 1 else [
        "--coordinator_address", f"127.0.0.1:{port}", "--num_processes",
        str(world), "--process_id", str(rank), "--mesh_model", str(model)]
    work = os.path.join(out_dir, f"w{tag}_r{rank}")
    os.makedirs(work)
    res = {}
    if world <= 2:  # the runner: a; at model 2 also resumed b, straight c
        exp = {k: os.path.join(out_dir, f"runner_{tag}_{k}")
               for k in "abc"}
        res["runner"] = {"a": _runner(exp["a"], work, flags, 1)}
        if world == 2:  # b resumes a copy of a's directory
            if rank == 0:
                shutil.copytree(exp["a"], exp["b"])
            pdist.barrier()
            res["runner"].update(
                b=_runner(exp["b"], work, flags, 2, "--resume"),
                c=_runner(exp["c"], work, flags, 2))
        res["ft_runner"] = _ft_runner(
            os.path.join(out_dir, f"ft_runner_{tag}"), work, flags)
    if world > 2:
        pdist.initialize_multihost(f"127.0.0.1:{port}", world, rank)

    inputs = os.path.join(out_dir, "inputs.pt")
    t0 = time.time()
    while not os.path.exists(inputs):
        if time.time() - t0 > WORKER_TIMEOUT:
            raise TimeoutError("no inputs.pt")
        time.sleep(0.2)
    inp = torch.load(inputs, weights_only=False)

    def pretrain_steps(cfg, draws_list, gen_seed=None, mlp_bwd=None):
        """Steps from JAX's initial parameters on this data rank's block
        (the mesh is made first)."""
        lo = pdist.data_rank() * B // data
        a, v = (t[lo:lo + B // data] for t in inp["batch"])
        if mlp_bwd:
            os.environ["AVSIAM_MLP_BWD"] = mlp_bwd
        else:
            os.environ.pop("AVSIAM_MLP_BWD", None)
        state = pt.init_state(cfg, device="cpu")
        load_full_state_dict(state.model, inp["params0"])
        step = pt.make_pretrain_step(cfg)
        gen = (None if gen_seed is None
               else torch.Generator().manual_seed(gen_seed))
        steps = []
        for draws in draws_list:
            state, m = step(state, (a, v), gen, LR, draws=draws)
            steps.append(dict(metrics={k: x.clone() for k, x in m.items()},
                              **_snapshot(state)))
        return steps

    if data == 1:  # one step under each other MLP form
        cfg = inp["pretrain_cfg"]["exact"]
        res["other_mlp"] = {
            (impl, bwd): pretrain_steps(pt.replace(cfg, model=pt.replace(
                cfg.model, mlp_impl=impl)), [None], gen_seed=5,
                mlp_bwd=bwd)[0]
            for impl, bwd in OTHER_MLP}
        os.environ.pop("AVSIAM_MLP_BWD", None)
    if world == 1:
        torch.save(res, os.path.join(out_dir, f"result_{tag}_r{rank}.pt"))
        return

    # the refusals in a world of model ranks
    pcfg = inp["pretrain_cfg"]["exact"]
    refused = []
    for mesh_cfg, mcfg in ((MeshConfig(model=model), pt.replace(
            pcfg.model, vit=pt.replace(pcfg.model.vit, num_heads=3,
                                       dim=96))),
                           (MeshConfig(data=world, model=model), None),
                           (MeshConfig(model=3), None)):
        try:
            make_mesh(mesh_cfg, mcfg)
        except SystemExit as err:
            refused.append(str(err))
    res["refused"] = refused
    mesh = make_mesh(MeshConfig(model=model), pcfg.model)
    res["mesh"] = dict(mesh=tuple(mesh), data_rank=pdist.data_rank(),
                       model_rank=pdist.model_rank(),
                       data_size=pdist.data_size(),
                       model_size=pdist.model_size())
    res["pretrain"] = {}
    forms = FORMS if model == 2 and data == 1 else ("exact",)
    for form in forms:
        draws = inp["draws"][form][:2 if data == 1 else 1]
        res["pretrain"][form] = pretrain_steps(inp["pretrain_cfg"][form],
                                               draws)
    if data == 1:
        res["tome"] = _tome_block(inp["tome"])
        fcfg = inp["ft_cfg"]
        fstate = ft.init_state(fcfg, torch.Generator().manual_seed(0), "cpu")
        load_full_state_dict(fstate.model, inp["ft_params0"])
        fstep = ft.make_finetune_step(fcfg)
        res["finetune"] = []
        for batch, u in zip(inp["ft_batches"], inp["ft_us"]):
            fstate, m = fstep(fstate, batch, inp["ft_lr"], u)
            res["finetune"].append(dict(loss=m["loss"].clone(),
                                        **_snapshot(fstate)))
    pdist.barrier()
    torch.save(res, os.path.join(out_dir, f"result_{tag}_r{rank}.pt"))


# ------------------------------------------------------------------ fixture
@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This module's comparisons are many small tensor ops: one intra-op
    thread for them (restored after), so that on a loaded host the idle
    threads' waits do not multiply each op's cost. No result depends on
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port():
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _launch(out_dir, data, model, rank, port):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [REPO, os.path.join(REPO, "tests"),
                      os.environ.get("PYTHONPATH")])), OMP_NUM_THREADS="1")
    env.pop("AVSIAM_PLATFORM", None)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), out_dir, str(data),
         str(model), str(rank), str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)


def _jax_references():
    """JAX's steps on (1, 2) and (2, 2) meshes through ``_shard_state``,
    the draws they make, and the port's inputs for them."""
    import jax
    import jax.numpy as jnp

    import avsiam_tpu.train.pretrain as jpretrain
    from avsiam_tpu import configs as jc
    from avsiam_tpu.models import CAVMAEPretrain as JaxModel
    from avsiam_tpu.models.cavmae_ft import CAVMAEFinetune as JaxFT
    from avsiam_tpu.parallel.mesh import batch_sharding, make_mesh
    from avsiam_tpu.train import finetune as jft
    from avsiam_tpu.train.loops import _shard_state
    from avsiam_tpu_torch import configs as pc
    from avsiam_tpu_torch.utils.weights import params_from_jax
    from test_torch_port_common import batch, configs, draws_from
    from test_torch_port_dist import _recorder
    from test_torch_port_finetune import _route_keys, ft_configs
    from test_torch_port_step import _fresh, _moments

    meshes = {(d, m): make_mesh(jc.MeshConfig(data=d, model=m))
              for d, m in WORLDS if d * m > 1}

    def on_mesh(mesh, state, *batch_arrays):
        bs = batch_sharding(mesh)
        return (_shard_state(_fresh(state), mesh),
                tuple(jax.device_put(x, bs) for x in batch_arrays))

    mp = pytest.MonkeyPatch()
    ref = {"pretrain": {w: {} for w in meshes}}
    inp = {"draws": {}, "pretrain_cfg": {}}
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
            recorders = {w: _recorder(mp, model, *w)
                         for w in ((0.0, 1.0), (1.0, 0.0))}
            draws = []
            for s in range(2):
                k_mask1, k_perm1, k_mask2, k_perm2 = jax.random.split(
                    jax.random.fold_in(step_rng, s), 4)
                draws.append(tuple(
                    draws_from(jax.tree_util.tree_map(np.array, recorders[w](
                        state.params, a, v, {"mask": km, "perm": kp})),
                        *w, form)
                    for w, km, kp in (((0.0, 1.0), k_mask1, k_perm1),
                                      ((1.0, 0.0), k_mask2, k_perm2))))
            inp["draws"][form] = draws
            for w, mesh in meshes.items():
                if form != "exact" and w != (1, 2):
                    continue
                jstate, (ja, jv) = on_mesh(mesh, state, a, v)
                steps = []
                for s in range(2 if w == (1, 2) else 1):
                    with mesh:
                        jstate, jm = jstep(jstate, (ja, jv), step_rng,
                                           jnp.float32(LR))
                    steps.append(dict(
                        jax_metrics=jax.device_get(jm),
                        jax_params=params_from_jax(jax.device_get(
                            jstate.params)),
                        jax_opt=[_moments(o) for o in (jstate.opt1,
                                                       jstate.opt2)]))
                ref["pretrain"][w][form] = steps
    finally:
        mp.undo()

    # the gated 'mm_grad' finetune step on the (1, 2) mesh, one branch a
    # step
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
    jstate = jax.device_get(jft.init_state(jax.random.PRNGKey(0), jmodel,
                                           jcfg, ft_batches[0]))
    ref["ft_params0"] = jstate.params
    jstep = jft.make_finetune_step(jmodel, jcfg)
    mesh = meshes[(1, 2)]
    jstate = _shard_state(_fresh(jstate), mesh)
    ref["finetune"] = []
    for fb in ft_batches:
        with mesh:
            jstate, jm = jstep(jstate, tuple(
                jax.device_put(x, batch_sharding(mesh)) for x in fb), key,
                jnp.float32(jcfg.opt.lr))
        ref["finetune"].append((float(jm["loss"]), jax.device_get(jstate)))
    inp.update(ft_params0=params_from_jax(ref["ft_params0"]), ft_us=us,
               ft_batches=[tuple(map(torch.from_numpy, fb))
                           for fb in ft_batches])

    # a ToMe block (r > 0, 'a' norms, dense MLP) at dim 128, 2 heads
    from avsiam_tpu.models.layers import ModalityBlock as JaxBlock
    tx = np.random.RandomState(8).randn(2, 24, 128).astype(np.float32)
    jblk = JaxBlock(128, 2)
    tparams = jax.device_get(jblk.init(
        jax.random.PRNGKey(3), tx, method=lambda m, x: [
            m(x, mod) for mod in (None, "a", "v")]))["params"]
    out, keep = jax.device_get(jblk.apply({"params": tparams}, tx, "a",
                                          None, TOME_R))
    ref["tome"] = dict(out=np.asarray(out), keep=np.asarray(keep))
    inp["tome"] = dict(params=params_from_jax(tparams),
                       x=torch.from_numpy(tx))
    return ref, inp


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("tp"))
    procs = {}
    for data, model in WORLDS:
        port = _free_port()
        for r in range(data * model):
            procs[(data, model, r)] = _launch(out_dir, data, model, r, port)
    try:
        ref, inp = _jax_references()
        tmp = os.path.join(out_dir, "inputs.pt.tmp")
        torch.save(inp, tmp)
        os.replace(tmp, os.path.join(out_dir, "inputs.pt"))
        io = {k: p.communicate(timeout=WORKER_TIMEOUT)
              for k, p in procs.items()}
    finally:
        # kill every rank: a rank left waiting on its peer would hold the
        # port and a core for the rest of the suite
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for k, p in procs.items():
        so, se = io[k]
        assert p.returncode == 0, f"worker {k} failed:\n{so}\n{se[-6000:]}"
    res = {(d, m): [torch.load(os.path.join(
        out_dir, f"result_{d}x{m}_r{r}.pt"), weights_only=False)
        for r in range(d * m)] for d, m in WORLDS}
    return dict(ref=ref, inp=inp, res=res, out_dir=out_dir,
                stdout={k: so for k, (so, _) in io.items()})


# ------------------------------------------------------------------- checks
def _close(got, want, name):
    """rtol 5e-4, atol 1e-5, elementwise."""
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=name)


def _outside(got, want):
    """The elements of ``got`` outside rtol 5e-4, atol 1e-5 of ``want``."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return int(((got - want).abs() > ATOL + RTOL * want.abs()).sum())


def _check_state(got_params, got_opt, ref, p0, s):
    """Parameters and moments against JAX's. The moments of the first
    pass's Adam after the first step, whose gradient both take at the same
    parameters, elementwise at rtol 5e-4, atol 1e-5; every other moment
    and every parameter with at most ``LOOSE`` of its elements outside that
    tolerance, and under ``test_torch_port_step.py``'s rules: Adam moves an
    element by about lr * g / (|g| + eps) in each pass, so an element whose
    gradient is within some tens of eps of rounding noise (the key bias's
    exact gradient is 0; the weight decay adds a few eps) moves by an
    amount that noise sets (measured: 2 of 24229 qkv weights off by 0.18
    lr after one step)."""
    from test_torch_port_step import _check_adam_moments, _check_params
    _check_params(dict(params=got_params, jax_params=ref["jax_params"]),
                  p0, s)
    n_out = n_total = 0
    for name, want in ref["jax_params"].items():
        n_out += _outside(got_params[name], want)
        n_total += want.numel()
    assert n_out <= LOOSE * n_total, (n_out, n_total)
    mine = [tuple({n: st[k] for n, st in got_opt[o].items()}
                  for k in ("exp_avg", "exp_avg_sq")) for o in ("opt1",
                                                                "opt2")]
    n_out = n_total = 0
    for i, ((jmu, jnu), (mu, nu)) in enumerate(zip(ref["jax_opt"], mine)):
        _check_adam_moments(dict(opt=mine, jax_opt=ref["jax_opt"]), s, i)
        for name in jmu:
            for g, w in ((mu[name], jmu[name]), (nu[name], jnu[name])):
                if (s, i) == (0, 0):
                    _close(g, w, name)
                n_out += _outside(g, w)
                n_total += w.numel()
    assert n_out <= LOOSE * n_total, (n_out, n_total)


def _tensors(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _tensors(t, f"{prefix}/{i}")


def _same_bits(r0, r1):
    for (n0, t0), (n1, t1) in zip(_tensors(r0), _tensors(r1), strict=True):
        assert n0 == n1 and torch.equal(t0, t1), n0


# ------------------------------------------------------------ (a) and (b)
def _jax_ft_param_paths():
    from flax import traverse_util

    from avsiam_tpu.models.cavmae_ft import CAVMAEFinetune as JaxFT
    from test_torch_port_finetune import ft_batch, ft_configs
    import jax
    jcfg, _ = ft_configs(kernels=False)
    a, v, _ = ft_batch()
    tree = jax.eval_shape(lambda: JaxFT(jcfg.model).init(
        jax.random.PRNGKey(0), a, v, "mm_grad", False))
    return list(traverse_util.flatten_dict(tree["params"], sep="/"))


@pytest.mark.parametrize("which", ["pretrain", "finetune"])
def test_rule_table_matches_jax_param_pspec(which):
    """Every parameter of the model is split where JAX's ``param_pspec``
    splits its flax counterpart, along the same dimension in nn.Linear's
    layout (a kernel's [in, out] is the weight's [out, in]), and
    replicated where JAX replicates it."""
    from avsiam_tpu.parallel.mesh import param_pspec as jax_pspec
    from avsiam_tpu_torch.parallel.mesh import param_pspec
    from avsiam_tpu_torch.utils.weights import port_name
    from test_torch_port_common import jax_param_paths
    paths = jax_param_paths() if which == "pretrain" else _jax_ft_param_paths()
    n_split = 0
    for path in paths:
        name, transposed = port_name(tuple(path.split("/")))
        want = tuple(jax_pspec(path))
        if transposed:
            want = want[::-1]
        got = param_pspec(name)
        assert got == want, (path, name, got, want)
        n_split += "model" in got
    # qkv (weight, bias), proj, fc1 (weight, bias), fc2 of every block
    blocks = sum(p.endswith("attn/qkv/kernel") for p in paths)
    assert blocks >= 3 and n_split == 6 * blocks


def _tiny_state_dict():
    from avsiam_tpu_torch.models.cavmae import CAVMAEPretrain
    from test_torch_port_common import configs
    _, pcfg = configs()
    return CAVMAEPretrain(pcfg.model, "cpu",
                          torch.Generator().manual_seed(3)).state_dict()


@pytest.mark.parametrize("model", [1, 2, 4])
def test_shard_and_gather_round_trip(model):
    """``gather_state_dict`` of the ranks' ``shard_state_dict`` is the full
    state_dict bit for bit; a replicated entry is the whole tensor on every
    rank, a split one 1/model of it along its dim."""
    from avsiam_tpu_torch.parallel.mesh import split_dim
    from avsiam_tpu_torch.utils.weights import (gather_state_dict,
                                                shard_state_dict)
    sd = _tiny_state_dict()
    if model == 4:  # the ViT's 2 heads do not split 4 ways
        sd = {k: v for k, v in sd.items() if k.startswith("decoder.")}
    shards = [shard_state_dict(sd, r, model) for r in range(model)]
    back = gather_state_dict(shards)
    assert list(back) == list(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
        dim = split_dim(k)
        for s in shards:
            if dim is None or model == 1:
                assert s[k] is v
            else:
                want = list(v.shape)
                want[dim] //= model
                assert list(s[k].shape) == want, k


@pytest.mark.parametrize("model", [2, 4])
def test_qkv_shard_holds_its_heads_q_k_and_v(model):
    """Each rank's qkv rows (weight and bias) are q, k and v of its own
    heads, in that order: [q_r | k_r | v_r], not a contiguous cut of the
    [q | k | v] rows."""
    from avsiam_tpu_torch.utils.weights import shard_state_dict
    heads, hd, c = 4, 8, 32
    # row i of part j (q, k, v) of head h carries the value 1000 j + i
    tag = torch.tensor([1000.0 * j + i for j in range(3)
                        for i in range(heads * hd)])
    sd = {"blocks.0.attn.qkv.weight": tag[:, None].repeat(1, c),
          "blocks.0.attn.qkv.bias": tag.clone()}
    per = heads // model
    for r in range(model):
        s = shard_state_dict(sd, r, model)
        want = torch.tensor([1000.0 * j + i for j in range(3)
                             for i in range(r * per * hd,
                                            (r + 1) * per * hd)])
        assert torch.equal(s["blocks.0.attn.qkv.bias"], want)
        assert torch.equal(s["blocks.0.attn.qkv.weight"][:, 0], want)


# ------------------------------------------------------------------- (c)
@pytest.mark.parametrize("s", [0, 1], ids=["step1", "step2"])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("rank", [0, 1])
def test_model2_pretrain_step_matches_jax_mesh(tp, form, s, rank):
    """Data 1 x model 2, each rank against JAX's step on a (1, 2) mesh:
    metrics at rtol 5e-4, atol 1e-5; the gathered parameters and both
    Adams' moments by ``_check_state``."""
    got = tp["res"][(1, 2)][rank]["pretrain"][form][s]
    ref = tp["ref"]["pretrain"][(1, 2)][form][s]
    for k, want in ref["jax_metrics"].items():
        _close(got["metrics"][k], want, k)
    p0 = tp["inp"]["params0"] if s == 0 else \
        tp["ref"]["pretrain"][(1, 2)][form][s - 1]["jax_params"]
    _check_state(got["params"], got, ref, p0, s)


@pytest.mark.parametrize("form", FORMS)
def test_model2_ranks_hold_the_same_replicated_bits(tp, form):
    """After each step both ranks hold the same bits in every metric, every
    replicated parameter and every gathered tensor (the model group's
    collectives are exact)."""
    r0, r1 = (tp["res"][(1, 2)][r]["pretrain"][form] for r in (0, 1))
    _same_bits(r0, r1)
    assert len(r0[0]["replicated"]) > 10


def test_model2_tome_block_matches_jax(tp):
    """ToMe's metric under the 'model' axis: each rank holds one of the two
    heads, sums its keys, adds the sums over the model group and divides
    by both heads, so that each rank draws the whole width's plan. Both
    ranks' keep masks exactly JAX's ``ModalityBlock.apply(x, 'a', None,
    r)``, their outputs within rtol 5e-4, atol 1e-5 of it, and their
    metrics the same bits, within 1e-6 of a world of one's."""
    want = tp["ref"]["tome"]
    whole = _tome_block(tp["inp"]["tome"], shard=False)
    ranks = [tp["res"][(1, 2)][r]["tome"] for r in (0, 1)]
    assert whole["heads"] == 2
    for r in ranks:
        assert r["heads"] == 1
        np.testing.assert_array_equal(r["keep"].numpy(), want["keep"])
        _close(r["out"], want["out"], "tome out")
        np.testing.assert_allclose(r["metric"].numpy(),
                                   whole["metric"].numpy(), rtol=0,
                                   atol=1e-6)
    assert (~ranks[0]["keep"]).sum(dim=1).tolist() == [TOME_R] * 2
    assert torch.equal(ranks[0]["metric"], ranks[1]["metric"])
    np.testing.assert_array_equal(whole["keep"].numpy(), want["keep"])


@pytest.mark.parametrize("impl,mlp_bwd", OTHER_MLP,
                         ids=[f"{i}-{b}" if b else i for i, b in OTHER_MLP])
def test_model2_other_mlp_forms_match_one_process(tp, impl, mlp_bwd):
    """One 'exact' step under ``mlp_impl`` 'dense' (the column- and
    row-parallel GEMMs of ``parallel/tp.py``), 'fused' and 'fbwd' (the
    fused forms' partial products), and 'fused' under
    ``AVSIAM_MLP_BWD=split`` (K8's partial dx) at data 1 x model 2
    against the port's world of one on the same draws (a generator of seed
    5): metrics within 1e-5 relative, parameters and moments by
    ``_check_state``'s rules."""
    one = tp["res"][(1, 1)][0]["other_mlp"][(impl, mlp_bwd)]
    ref = dict(jax_params=one["params"],
               jax_opt=[tuple({n: st[k] for n, st in one[o].items()}
                              for k in ("exp_avg", "exp_avg_sq"))
                        for o in ("opt1", "opt2")])
    for r in (0, 1):
        got = tp["res"][(1, 2)][r]["other_mlp"][(impl, mlp_bwd)]
        for k, want in one["metrics"].items():
            assert abs(float(got["metrics"][k]) - float(want)) <= 1e-5 * abs(
                float(want)), k
        _check_state(got["params"], got, ref, tp["inp"]["params0"], 0)


@pytest.mark.parametrize("s", [0, 1, 2])
def test_model2_gated_finetune_step_matches_jax_mesh(tp, s):
    """Step s (one 'mm_grad' branch a step) at data 1 x model 2 against
    JAX's gated Adam on a (1, 2) mesh: the loss at rtol 5e-4, atol 1e-5,
    parameters and moments at ``test_torch_port_finetune.py``'s
    tolerances, every step count exactly; the ranks the same bits."""
    import jax

    from avsiam_tpu_torch.utils.weights import params_from_jax
    from test_torch_port_finetune import _check_moments, _check_params
    jloss, jstate = tp["ref"]["finetune"][s]
    r0, r1 = (tp["res"][(1, 2)][r]["finetune"] for r in (0, 1))
    _same_bits(r0[s], r1[s])
    got = r0[s]
    _close(float(got["loss"]), jloss, "loss")
    if s == 0:
        jbefore, before = tp["ref"]["ft_params0"], tp["inp"]["ft_params0"]
    else:
        jbefore = tp["ref"]["finetune"][s - 1][1].params
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


# ------------------------------------------------------------------- (d)
@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_data2_model2_step_matches_jax_mesh_and_world1(tp, rank):
    """Data 2 x model 2: rank r is data rank r // 2 and model rank r % 2
    (the model groups consecutive ranks); its 'exact' step against JAX's
    on a (2, 2) mesh (metrics at rtol 5e-4, atol 1e-5, state by
    ``_check_state``) and against the data 1 x model 2 step (metrics within
    1e-5 relative); every rank the same bits."""
    res = tp["res"][(2, 2)]
    got = res[rank]
    assert got["mesh"] == dict(mesh=(2, 2), data_rank=rank // 2,
                               model_rank=rank % 2, data_size=2,
                               model_size=2)
    step = got["pretrain"]["exact"][0]
    ref = tp["ref"]["pretrain"][(2, 2)]["exact"][0]
    for k, want in ref["jax_metrics"].items():
        _close(step["metrics"][k], want, k)
    _check_state(step["params"], step, ref, tp["inp"]["params0"], 0)
    m2 = tp["res"][(1, 2)][0]["pretrain"]["exact"][0]["metrics"]
    for k, want in m2.items():
        assert abs(float(step["metrics"][k]) - float(want)) <= 1e-5 * abs(
            float(want)), k
    for other in res:
        _same_bits(other["pretrain"]["exact"][0]["metrics"], step["metrics"])
        _same_bits(other["pretrain"]["exact"][0]["params"], step["params"])


# ------------------------------------------------------------------- (e)
def _rows(path):
    with open(os.path.join(path, "result.csv"), newline="") as f:
        return list(csv.DictReader(f))


def test_model2_runner_matches_world1(tp):
    """The pretrain runner with ``--mesh_model 2``: ``result.csv``'s
    training columns within 1e-5 relative of the world of one's (the
    validation columns finite), rank 1 writes nothing, the final
    parameters within ``test_torch_port_step.py``'s Adam-noise rule of the
    world of one's and the same bits on both ranks."""
    out = tp["out_dir"]
    w1, w2 = (os.path.join(out, f"runner_{t}_a") for t in ("1x1", "1x2"))
    (r1,), (r2,) = _rows(w1), _rows(w2)
    for k, want in r1.items():
        if k.startswith("eval_"):
            assert np.isfinite(float(r2[k])), k
        else:
            assert abs(float(r2[k]) - float(want)) <= 1e-5 * max(
                abs(float(want)), 1e-30), k
    p0, p1 = (tp["res"][(1, 2)][r]["runner"]["a"] for r in (0, 1))
    single = tp["res"][(1, 1)][0]["runner"]["a"]
    lr, n_loose, n_total = 1e-4, 0, 0
    for n, t in p0.items():
        assert torch.equal(t, p1[n]), n
        diff = (t - single[n]).abs()
        assert float(diff.max()) <= 2 * lr * 2 + 1e-6, n
        n_loose += int((diff > 1e-3 * lr + 1e-6).sum())
        n_total += diff.numel()
    assert n_loose <= 5e-3 * n_total, (n_loose, n_total)
    stdout = tp["stdout"][(1, 2, 0)]
    assert "mesh: data=1 model=2 processes=2 backend=gloo" in stdout
    assert "mesh:" not in tp["stdout"][(1, 2, 1)]


def test_model2_resumed_run_equals_straight(tp):
    """``--resume`` to epoch 2 from the TP run's ``train_state.1`` against
    a straight two-epoch TP run: the final parameters and ``result.csv``
    the same bits."""
    out = tp["out_dir"]
    for r in (0, 1):
        got = tp["res"][(1, 2)][r]["runner"]
        for n, t in got["c"].items():
            assert torch.equal(got["b"][n], t), n
    assert _rows(os.path.join(out, "runner_1x2_b")) == _rows(
        os.path.join(out, "runner_1x2_c"))


def test_model2_finetune_runner_matches_world1(tp):
    """The finetune runner with ``--mesh_model 2`` (two epochs, the
    held-out eval, ``--wa``): ``result.csv`` within 1e-4 of the world of
    one's but for the host's timings (the metrics over 8 clips; the loss
    within 1e-4 relative), the
    held-out statistics within 1e-4, the averaged parameters within
    ``test_torch_port_step.py``'s Adam-noise bound (2 lr a step at the
    heads' rate, 100 x 1e-4), rank 1 writing nothing."""
    out = tp["out_dir"]
    (r1, r2), (g1, g2) = (_rows(os.path.join(out, f"ft_runner_{t}"))
                          for t in ("1x1", "1x2"))
    for got, want in ((g1, r1), (g2, r2)):
        assert got.keys() == want.keys()
        for k, w in want.items():
            if "time" not in k:  # the host's timings differ
                assert abs(float(got[k]) - float(w)) <= 1e-4 * max(
                    1.0, abs(float(w))), k
    got, want = (tp["res"][w][0]["ft_runner"] for w in ((1, 2), (1, 1)))
    for sg, sw in zip(got["eval_stats"], want["eval_stats"], strict=True):
        for k, w in sw.items():
            np.testing.assert_allclose(sg[k], w, rtol=1e-4, atol=1e-4,
                                       err_msg=k)
    for n, w in want["wa_params"].items():
        assert float((got["wa_params"][n] - w).abs().max()) <= (
            2 * 1e-2 * 4 + 1e-6), n
    assert "mesh: data=1 model=2 processes=2 backend=gloo" in tp[
        "stdout"][(1, 2, 0)]


def test_model2_checkpoint_loads_into_world1(tp):
    """The TP run's ``train_state.1`` (parameters, both Adams' moments and
    step counts, gathered and written by rank 0) restores into a fresh
    state of one process, its parameters the run's gathered ones bit for
    bit and its moments whole; ``best_audio_model`` loads strictly."""
    from avsiam_tpu_torch.models.variants import pretrain_config
    from avsiam_tpu_torch.train import pretrain as pt
    from avsiam_tpu_torch.utils import checkpoint as ck
    exp = os.path.join(tp["out_dir"], "runner_1x2_a")
    cfg = pt.PretrainConfig(model=pretrain_config("tiny",
                                                  dtype=torch.float32))
    fresh = pt.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    ck.restore_train_state(exp, "train_state.1", fresh)
    want = tp["res"][(1, 2)][0]["runner"]["a"]
    for n, p in fresh.model.named_parameters():
        assert torch.equal(p.detach(), want[n]), n
    for opt in (fresh.opt1, fresh.opt2):
        assert opt.state
        for p, st in opt.state.items():
            assert st["exp_avg"].shape == p.shape
    fresh.model.load_state_dict(ck.restore_params(exp, "best_audio_model"))


# ------------------------------------------------------------------- (f)
def test_refusals_in_a_model_world(tp):
    """In a world of model ranks, ``make_mesh`` refuses a model whose heads
    the axis does not split, data x model other than the world, and a
    model axis that does not divide the world, each naming it."""
    for (d, m), results in tp["res"].items():
        if d * m == 1:
            continue
        heads, data, model = results[0]["refused"]
        assert "does not divide the 3 attention heads" in heads
        assert "does not match the world" in data
        assert "does not divide the world" in model


@pytest.mark.parametrize("case", ["heads", "hidden", "kernel_width",
                                  "world", "data"])
def test_make_mesh_refuses(case):
    """Refused with a SystemExit that says why: heads the model axis does
    not divide; an MLP hidden width it does not divide; a shard width the
    MLP kernels do not take where they take the whole (no silent fall
    back to the plain MLP); data x model other than the world of one."""
    from avsiam_tpu_torch import configs as pc
    from avsiam_tpu_torch.parallel.mesh import make_mesh, tp_refusal
    from test_torch_port_common import configs
    _, pcfg = configs()
    m = pcfg.model
    vit = m.vit
    if case == "heads":
        assert "3 attention heads of the ViT" in tp_refusal(
            2, pc.replace(m, vit=pc.replace(vit, num_heads=3, dim=96)))
    elif case == "hidden":
        assert "hidden width 150 of the ViT" in tp_refusal(
            4, pc.replace(m, vit=pc.replace(vit, num_heads=4, dim=100,
                                            mlp_ratio=1.5)))
    elif case == "kernel_width":
        # the whole 512 takes the kernels, a quarter (128) too, an eighth
        # (64) not
        assert tp_refusal(4, pc.replace(m, vit=pc.replace(
            vit, num_heads=8), decoder=pc.replace(m.decoder, num_heads=8)
        )) is None
        why = tp_refusal(8, pc.replace(m, vit=pc.replace(vit, num_heads=8),
                                       decoder=pc.replace(m.decoder,
                                                          num_heads=8)))
        assert "hidden width 64" in why and "MLP kernels" in why
    elif case == "world":
        with pytest.raises(SystemExit, match="does not divide the world"):
            make_mesh(pc.MeshConfig(model=2), m)
    else:
        with pytest.raises(SystemExit, match="does not match the world"):
            make_mesh(pc.MeshConfig(data=2, model=1))


@pytest.mark.parametrize("local_world,cards,want", [
    (1, 1, "nccl"), (4, 4, "nccl"), (2, 4, "nccl"), (2, 1, "gloo"),
    (8, 4, "gloo"), (1, 0, None)])
def test_card_backend_follows_ranks_and_cards(local_world, cards, want):
    """On the card the backend comes from the host's ranks and its cards:
    NCCL with a card a rank, gloo with more ranks than cards (NCCL refuses
    two ranks on one device), and no card at all raises. Without a group
    the mesh's helpers describe a world of one replica of one rank."""
    from avsiam_tpu_torch.parallel import dist as pdist
    if want is None:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pdist.card_backend(local_world, cards)
    else:
        assert pdist.card_backend(local_world, cards) == want
    assert not pdist.active() and pdist.backend() is None
    assert (pdist.data_size(), pdist.model_size(), pdist.data_rank(),
            pdist.model_rank()) == (1, 1, 0, 0)
    assert pdist.data_group() is None and pdist.model_group() is None


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
            int(sys.argv[4]), int(sys.argv[5]))
