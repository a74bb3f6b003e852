"""Port parity of the finetune loop and what serves it: checkpoints
(``average_checkpoints``, ``transfer_pretrain_to_ft``), the reference
import (``import_cavmae_ft``), ``validate_ft``, ``run_finetune``,
``linear_probe`` and the finetune runner (``cli/finetune.py``).

- ``average_checkpoints`` and ``transfer_pretrain_to_ft`` against the JAX
  package's (orbax files on its side, ``torch.save`` files on the port's),
  bit for bit in float32.
- ``import_cavmae_ft`` on a synthetic reference-format state_dict (a
  finetune one with every head, and a pretrain one with none and a block
  without its video norms) against the JAX importer: every tensor bit for
  bit, the fresh-kept names and the unused keys.
- The loop's bookkeeping against the JAX loop: both packages' steps and
  eval forwards are stubbed (pytest monkeypatch) with losses from the step
  count and logits from the eval call and the clip's labels, and their
  saves with ones that record the name; the loops run their own code
  around them, ``validate_ft`` included: ``result.csv``'s rows but for the
  timings, the ``stats_{e}.pickle`` files (1e-12), the best epoch and
  metric, the checkpoint names, the averaging's epochs, the early stop,
  under mAP and accuracy, MultiStepLR and the plateau scheduler.
- Real steps on the CPU at the tiny geometry: two epochs straight equal
  one epoch and a ``--resume`` bit for bit (parameters, Adam's moments
  and step counts, ``result.csv``); ``best_audio_model`` is the best
  epoch's checkpoint; ``wa`` averages the epochs' files.
- ``linear_probe`` against the JAX probe from the same initial heads and
  batches: each of the three modes' mAP and AUC within 1e-5. 'audioonly'
  and 'videoonly' read heads the 'joint_av' loss never reaches, which
  both packages' Adam moves on weight decay alone.
- The parser against the JAX one (every dest and default), each
  ``recipes/ft_*.sh`` command line to the same config through both mains,
  and the runner under ``AVSIAM_PLATFORM=cpu``.
"""

import os
import pickle
import re
import shlex
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avsiam_tpu.cli.finetune as jcli
import avsiam_tpu.train.loops as jloops
import avsiam_tpu.utils.checkpoint as jck
from avsiam_tpu import configs as jc
from avsiam_tpu.data.dataset import AVDataset as JaxDataset
from avsiam_tpu.models import CAVMAEPretrain as JaxPretrain
from avsiam_tpu.models.cavmae_ft import CAVMAEFinetune as JaxModel
from avsiam_tpu.train import finetune as jft
from avsiam_tpu.utils.torch_import import import_cavmae_ft as jax_import_ft
from avsiam_tpu_torch import configs as pc
from avsiam_tpu_torch.cli import finetune as cli
from avsiam_tpu_torch.data.dataset import AVDataset
from avsiam_tpu_torch.models.cavmae import CAVMAEPretrain
from avsiam_tpu_torch.train import finetune as ft
from avsiam_tpu_torch.train import loops
from avsiam_tpu_torch.utils import checkpoint as ck
from avsiam_tpu_torch.utils.torch_import import import_cavmae_ft
from avsiam_tpu_torch.utils.weights import params_from_jax, port_name
from test_torch_port_common import VIT, configs
from test_torch_port_metrics import _assert_stats_equal

REPO = Path(__file__).resolve().parents[1]
AUDIO = dict(target_length=VIT["audio_length"], num_mel_bins=VIT["mel_bins"])
CLASSES, FRAMES = 3, 3
TIMES = ("per_sample_time", "per_sample_data_time", "per_sample_dnn_time")


@pytest.fixture
def index_json(tmp_path):
    p = tmp_path / "idx.json"
    p.write_text('{"data": [%s]}' % ", ".join(
        '{"wav": "/fake/%d.wav", "labels": "/m/%d%s"}'
        % (i, i % 3, ",/m/2" if i % 4 == 0 else "") for i in range(10)))
    csvp = tmp_path / "labels.csv"
    csvp.write_text("index,mid,display_name\n0,/m/0,a\n1,/m/1,b\n2,/m/2,c\n")
    return str(p), str(csvp)


def _datasets(index_json, cls, audio_cls):
    path, csvp = index_json
    return tuple(cls(path, audio_cls(**AUDIO), label_csv=csvp, mode=mode,
                     frame_source="synthetic", im_res=VIT["img_size"],
                     num_frames=FRAMES) for mode in ("train", "eval"))


def ft_configs(batch=4, **kw):
    """(JAX FinetuneConfig, port FinetuneConfig) at the tiny geometry (the
    JAX model on its XLA attention and dense MLP, which compile fastest)."""
    def make(c, **model_kw):
        return c.FinetuneConfig(
            model=c.CAVMAEFTConfig(vit=c.ViTConfig(**VIT), label_dim=CLASSES,
                                   num_eval_frames=FRAMES, **model_kw),
            audio=c.AudioConfig(**AUDIO), batch_size=batch, **kw)

    return (make(jc, attn_impl="xla", mlp_impl="dense"), make(pc))


def _jax_ft_params(jcfg, seed=0):
    model = JaxModel(jcfg.model)
    a = np.zeros((1, VIT["audio_length"], VIT["mel_bins"]), np.float32)
    v = np.zeros((1, 1, 3, VIT["img_size"], VIT["img_size"]), np.float32)
    return jax.device_get(jax.jit(lambda r: model.init(
        r, a, v, "mm_grad", False))(jax.random.PRNGKey(seed))["params"])


def _random_like(tree, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: rs.randn(*np.shape(x)).astype(np.float32), tree)


# ------------------------------------------------------------ checkpoints
def test_average_checkpoints_matches_jax(tmp_path):
    """Three epochs' params averaged over [1, 3] and [2, 3]: the same
    float32 bits as the JAX package's float64 average."""
    jcfg, _ = ft_configs()
    trees = [_random_like(_jax_ft_params(jcfg), s) for s in range(3)]
    for e, tree in enumerate(trees, start=1):
        jck.save_params(str(tmp_path / "jax"), f"audio_model.{e}", tree)
        sd = params_from_jax(tree)
        ck._save(sd, ck._path(str(tmp_path / "port"), f"audio_model.{e}"))
    for lo in (1, 2):
        want = params_from_jax(jck.average_checkpoints(
            str(tmp_path / "jax"), lo, 3, like=trees[0]))
        got = ck.average_checkpoints(str(tmp_path / "port"), lo, 3)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == torch.float32
            assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="no checkpoints"):
        ck.average_checkpoints(str(tmp_path / "port"), 3, 2)


@pytest.mark.parametrize("refresh", [False, True])
def test_transfer_pretrain_to_ft_matches_jax(refresh):
    """The pretrain trunk (and fusion layers, or with ``refresh_fusion``
    copies of the trunk's last two blocks) over a finetune state, bit for
    bit as the JAX package's."""
    jcfg, pcfg = configs()
    m = jc.replace(jcfg.model, vit=jc.replace(jcfg.model.vit, depth=3))
    a = np.zeros((1, VIT["audio_length"], VIT["mel_bins"]), np.float32)
    v = np.zeros((1, 3, VIT["img_size"], VIT["img_size"]), np.float32)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(JaxPretrain(m).init, {"params": key, "mask": key,
                                                  "perm": key}, a, v)
    pre = _random_like(shapes["params"], 1)
    fcfg, _ = ft_configs()
    fcfg = jc.replace(fcfg, model=jc.replace(fcfg.model, vit=m.vit))
    fresh = _random_like(_jax_ft_params(fcfg), 2)
    want = params_from_jax(jck.transfer_pretrain_to_ft(pre, fresh,
                                                       refresh_fusion=refresh))
    got = ck.transfer_pretrain_to_ft(params_from_jax(pre),
                                     params_from_jax(fresh),
                                     refresh_fusion=refresh)
    assert list(got) == list(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    src = "vit.blocks.2." if refresh else "mm_layer_2."
    assert torch.equal(got["mm_layer_2.attn.qkv.weight"],
                       params_from_jax(pre)[src + "attn.qkv.weight"])


def _reference_sd(fresh_port, depth, heads=True, drop_v_norms=None):
    """A reference-format state_dict with the shapes of ``fresh_port``
    (the port's finetune state_dict): the trunk under 'module.vit_base.',
    the conv patch embeds, the fusion layers, the heads (with ``heads``)
    as Sequential(LayerNorm, Linear), and keys no model part takes."""
    g = torch.Generator().manual_seed(3)

    def r(*shape):
        return torch.randn(shape, generator=g)

    dim = fresh_port["vit.norm.weight"].shape[0]
    p = VIT["patch_size"]
    sd = {"vit_base.patch_embed.proj.weight": r(dim, 3, p, p),
          "vit_base.patch_embed_a.proj.weight": r(dim, 1, p, p),
          "cls_token": r(1, 1, dim), "decoder_pred_a.weight": r(4, 4)}
    for k, t in fresh_port.items():
        if k.startswith("vit.") and "patch_embed" not in k:
            sd["vit_base." + k[4:]] = r(*t.shape)
        if k.startswith("vit.patch_embed") and k.endswith("bias"):
            sd["vit_base." + k[4:]] = r(*t.shape)
        if k.startswith("mm_layer_"):
            sd[k] = r(*t.shape)
        if heads and k.startswith("mlp_head"):
            name, mod, leaf = k.split(".")
            sd[f"{name}.{0 if mod == 'ln' else 1}.{leaf}"] = r(*t.shape)
    if drop_v_norms is not None:
        sd = {k: t for k, t in sd.items()
              if not re.match(rf"vit_base\.blocks\.{drop_v_norms}\.norm[12]_v",
                              k)}
    return {("module." + k if i % 2 else k): t
            for i, (k, t) in enumerate(sd.items())}


@pytest.mark.parametrize("kind", ["finetune", "pretrain"])
def test_import_cavmae_ft_matches_jax(kind):
    """The merged state_dict bit for bit, the names kept fresh and the
    unused keys, as the JAX importer gives them."""
    jcfg, _ = ft_configs()
    fresh = _random_like(_jax_ft_params(jcfg), 4)
    fresh_port = params_from_jax(fresh)
    depth = VIT["depth"]
    sd = _reference_sd(fresh_port, depth, heads=kind == "finetune",
                       drop_v_norms=0 if kind == "pretrain" else None)
    want, jmissing, junused = jax_import_ft(
        {k: t.numpy() for k, t in sd.items()}, fresh, depth=depth)
    got, missing, unused = import_cavmae_ft(sd, fresh_port, depth=depth)
    want = params_from_jax(want)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert missing == [port_name(tuple(p.split("/")))[0] for p in jmissing]
    assert unused == junused
    assert bool(missing) == (kind == "pretrain")
    assert "cls_token" in unused


def test_import_refuses_a_shape_mismatch():
    jcfg, _ = ft_configs()
    fresh_port = params_from_jax(_jax_ft_params(jcfg))
    sd = _reference_sd(fresh_port, VIT["depth"])
    sd["mlp_head.1.weight"] = torch.zeros(7, 7)
    with pytest.raises(ValueError, match="shape mismatch"):
        import_cavmae_ft(sd, fresh_port, depth=VIT["depth"])


# --------------------------------------------------- the loop's bookkeeping
# eval quality by epoch (two eval batches an epoch): the metric rises,
# then falls for three epochs
QUALITY = (0.2, 1.0, 0.1, 0.05, 0.02, 2.0, 0.3, 0.3)


def _eval_logits(call: int, y: np.ndarray) -> np.ndarray:
    """The stub eval forward's [B, FRAMES, C] logits for eval call
    ``call``: the labels' sign times the epoch's quality plus noise."""
    rs = np.random.RandomState(call)
    q = QUALITY[min(call // 2, len(QUALITY) - 1)]
    noise = rs.randn(y.shape[0], FRAMES, y.shape[1]).astype(np.float32)
    return (q * (2 * y[:, None, :] - 1) + noise).astype(np.float32)


def _stub_jax(monkeypatch, record):
    calls = [0]

    def make_step(model, cfg):
        def step(state, batch, rng, lr):
            s = int(state.step)
            record["lrs"].append(float(lr))
            return state._replace(step=state.step + 1), {
                "loss": jnp.float32(1 + s / 4)}
        return step

    def make_eval(model, cfg):
        def ev(params, batch):
            calls[0] += 1
            return _eval_logits(calls[0] - 1, np.asarray(batch[2]))
        return ev

    def save(exp_dir, name, _):
        record["saves"].append(str(name))
        os.makedirs(os.path.join(exp_dir, "models", str(name)), exist_ok=True)

    def average(exp_dir, lo, hi, like=None):
        record["wa"].append((lo, hi))
        return {}

    monkeypatch.setattr(jft, "make_finetune_step", make_step)
    monkeypatch.setattr(jft, "make_ft_eval_step", make_eval)
    monkeypatch.setattr(jloops, "save_params", save)
    monkeypatch.setattr(jck, "save_train_state", save)
    monkeypatch.setattr(jloops, "average_checkpoints", average)


def _stub_port(monkeypatch, record):
    calls = [0]

    def make_step(cfg):
        def step(state, batch, lr, u=None):
            s = state.step
            state.step += 1
            record["lrs"].append(float(lr))
            return state, {"loss": torch.tensor(1 + s / 4)}
        return step

    def make_eval(cfg):
        def ev(model, batch):
            calls[0] += 1
            return torch.from_numpy(_eval_logits(calls[0] - 1,
                                                 batch[2].numpy()))
        return ev

    def save(exp_dir, name, _):
        record["saves"].append(str(name))
        path = os.path.join(exp_dir, "models", str(name))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        open(path, "wb").close()

    def average(exp_dir, lo, hi):
        record["wa"].append((lo, hi))
        return {}

    monkeypatch.setattr(ft, "make_finetune_step", make_step)
    monkeypatch.setattr(ft, "make_ft_eval_step", make_eval)
    monkeypatch.setattr(loops, "save_params", save)
    monkeypatch.setattr(loops, "save_train_state", save)
    monkeypatch.setattr(loops, "average_checkpoints", average)


CASES = {
    # mAP, per-epoch params, keep two train states, average epochs 1-3;
    # the metric falls for three epochs after the second: early stop
    "map_wa": dict(n_epochs=8, keep_train_states=2, wa=(1, 3),
                   train_state_every=3),
    # accuracy under CE, the plateau scheduler, no per-epoch params
    "acc_plateau": dict(n_epochs=6, metrics="acc", loss="CE",
                        save_model=False, n_print_steps=1,
                        opt=dict(lr_adapt=True, lr_patience=1)),
    # no validation, MultiStepLR decaying from epoch 2, a train state every
    # second epoch
    "no_val": dict(n_epochs=3, val=False, train_state_every=2,
                   opt=dict(lrscheduler_start=1, lrscheduler_step=1)),
}


def _run_ft_loop(run_finetune, cfgs_mod, cfg_base, datasets, exp_dir, case):
    case = dict(case)
    opt = case.pop("opt", {})
    val = case.pop("val", True)
    wa = case.pop("wa", None)
    cfg = cfgs_mod.replace(cfg_base, opt=cfgs_mod.replace(cfg_base.opt, **opt),
                           exp_dir=str(exp_dir), **case)
    kw = dict(device="cpu") if cfgs_mod is pc else {}
    if wa:
        kw.update(wa=True, wa_start=wa[0], wa_end=wa[1])
    return run_finetune(cfg, datasets[0], datasets[1] if val else None,
                        max_steps_per_epoch=2, log=lambda *a: None, **kw)


def _rows(rows):
    return [{k: v for k, v in r.items() if k not in TIMES} for r in rows]


@pytest.mark.parametrize("case", list(CASES))
def test_bookkeeping_matches_the_jax_loop(tmp_path, index_json, monkeypatch,
                                          case):
    jcfg, pcfg = ft_configs()
    jrec = dict(saves=[], lrs=[], wa=[])
    prec = dict(saves=[], lrs=[], wa=[])
    _stub_jax(monkeypatch, jrec)
    _stub_port(monkeypatch, prec)
    jout = _run_ft_loop(jloops.run_finetune, jc, jcfg,
                        _datasets(index_json, JaxDataset, jc.AudioConfig),
                        tmp_path / "jax", CASES[case])
    pout = _run_ft_loop(loops.run_finetune, pc, pcfg,
                        _datasets(index_json, AVDataset, pc.AudioConfig),
                        tmp_path / "port", CASES[case])
    got, want = _rows(pout["rows"]), _rows(jout["rows"])
    assert [r.keys() for r in got] == [r.keys() for r in want]
    for g, w in zip(got, want):
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-12, abs=1e-12), k
    assert (pout["best_epoch"], pout["best"]) == pytest.approx(
        (jout["best_epoch"], jout["best"]), rel=1e-12)
    assert prec["saves"] == jrec["saves"]
    # the JAX loop hands its step the rate as a float32
    assert [float(np.float32(x)) for x in prec["lrs"]] == jrec["lrs"]
    assert prec["wa"] == jrec["wa"]
    assert (sorted(os.listdir(tmp_path / "port"))
            == sorted(os.listdir(tmp_path / "jax")))
    assert (sorted(os.listdir(tmp_path / "port" / "models"))
            == sorted(os.listdir(tmp_path / "jax" / "models")))
    for f in os.listdir(tmp_path / "jax"):
        if f.startswith("stats_"):
            with open(tmp_path / "jax" / f, "rb") as fj, \
                    open(tmp_path / "port" / f, "rb") as fp:
                _assert_stats_equal(pickle.load(fp), pickle.load(fj))
    if case == "map_wa":
        assert len(got) < CASES[case]["n_epochs"]  # the early stop
    if case == "acc_plateau":
        assert got[-1]["lr"] < got[0]["lr"]  # the scheduler acted


def test_wa_needs_the_epoch_checkpoints(tmp_path, index_json):
    _, pcfg = ft_configs()
    cfg = pc.replace(pcfg, save_model=False, exp_dir=str(tmp_path))
    train, _ = _datasets(index_json, AVDataset, pc.AudioConfig)
    with pytest.raises(ValueError, match="save_model"):
        loops.run_finetune(cfg, train, wa=True, device="cpu")
    assert not (tmp_path / "models").exists()  # refused before training


# ------------------------------------------------------------ real steps
def _state_tensors(state):
    out = {f"param {n}": p.detach() for n, p in
           state.model.named_parameters()}
    names = {id(p): n for n, p in state.model.named_parameters()}
    for p, st in state.opt.state.items():
        for k, t in st.items():
            out[f"adam {k} {names[id(p)]}"] = t
    return out


def test_resumed_run_equals_the_straight_run(tmp_path, index_json):
    """Real 'mm_grad' steps on the CPU, two steps an epoch: epochs 1-2
    straight against epoch 1 then ``--resume`` to 2, bit for bit in every
    parameter, Adam moment and step count, and in ``result.csv``;
    ``best_audio_model`` is the best
    epoch's params; ``wa`` the float64 average of the epochs' files."""
    _, pcfg = ft_configs(seed=5, n_print_steps=1)
    train, val = _datasets(index_json, AVDataset, pc.AudioConfig)

    def run(exp, n_epochs, **kw):
        cfg = pc.replace(pcfg, n_epochs=n_epochs, exp_dir=str(tmp_path / exp))
        return loops.run_finetune(cfg, train, val, max_steps_per_epoch=2,
                                  log=lambda *a: None, device="cpu", **kw)

    straight = run("straight", 2, wa=True, wa_start=1, wa_end=9)
    run("resumed", 1)
    resumed = run("resumed", 2, resume=True)
    assert resumed["timing"]["restore_s"] is not None
    a, b = _state_tensors(straight["state"]), _state_tensors(resumed["state"])
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert _rows(straight["rows"]) == _rows(resumed["rows"])
    assert straight["state"].step == resumed["state"].step == 4
    assert sum(straight["state"].branches.values()) == 4
    rows = straight["rows"]
    assert all(np.isfinite([r["train_loss"], r["mAP"], r["acc"],
                            r["mAUC"], r["val_loss"]]).all() for r in rows)
    exp = str(tmp_path / "straight")
    best = max(rows, key=lambda r: r["mAP"])["epoch"]
    assert straight["best_epoch"] == best
    saved, epoch = (ck.restore_params(exp, n) for n in
                    ("best_audio_model", f"audio_model.{best}"))
    assert all(torch.equal(saved[k], epoch[k]) for k in saved)
    e1, e2 = (ck.restore_params(exp, f"audio_model.{e}") for e in (1, 2))
    for k, t in straight["wa_params"].items():
        want = ((e1[k].double() + e2[k].double()) / 2).float()
        assert torch.equal(t, want), k
    assert straight["timing"]["wa_s"] is not None
    assert sorted(os.listdir(Path(exp) / "models")) == [
        "audio_model.1", "audio_model.2", "best_audio_model", "train_state.2"]


def test_routing_follows_the_keyed_draws(tmp_path, index_json, monkeypatch):
    """The step routes step n by ``draw_route(seed, n)``."""
    _, pcfg = ft_configs(seed=11, n_epochs=2)
    seen = []
    real = ft.route
    monkeypatch.setattr(ft, "route", lambda u: seen.append(u) or real(u))
    train, _ = _datasets(index_json, AVDataset, pc.AudioConfig)
    loops.run_finetune(pc.replace(pcfg, exp_dir=str(tmp_path)), train,
                       max_steps_per_epoch=2, log=lambda *a: None,
                       device="cpu")
    assert seen == [ft.draw_route(11, n) for n in range(4)]


# ------------------------------------------------------------ linear probe
def test_linear_probe_matches_jax(tmp_path, index_json, monkeypatch):
    """Both probes from the same pretrain parameters and the same initial
    heads, on the same (unaugmented) batches."""
    jcfg, pcfg = configs(batch=4)
    jcfg = jc.replace(jcfg, model=jc.replace(jcfg.model, attn_impl="xla",
                                             mlp_impl="dense"),
                      audio=jc.AudioConfig(**AUDIO), exp_dir=str(tmp_path))
    pcfg = pc.replace(pcfg, audio=pc.AudioConfig(**AUDIO),
                      exp_dir=str(tmp_path))
    a = np.zeros((2, VIT["audio_length"], VIT["mel_bins"]), np.float32)
    v = np.zeros((2, 3, VIT["img_size"], VIT["img_size"]), np.float32)
    key = jax.random.PRNGKey(0)
    pre = jax.device_get(jax.jit(JaxPretrain(jcfg.model).init)(
        {"params": key, "mask": key, "perm": key}, a, v)["params"])
    # the JAX probe's fresh finetune parameters: init from PRNGKey(seed)
    probe_model = JaxModel(jc.CAVMAEFTConfig(vit=jcfg.model.vit,
                                             label_dim=CLASSES))
    fresh = jax.device_get(jax.jit(lambda r: probe_model.init(
        r, a, v[:, None], "joint_av", False))(
        jax.random.PRNGKey(jcfg.seed))["params"])
    real_init = ft.init_state

    def init_from_jax(cfg, generator=None, device="cuda"):
        state = real_init(cfg, generator, device)
        state.model.load_state_dict(params_from_jax(fresh))
        return state

    monkeypatch.setattr(ft, "init_state", init_from_jax)
    kw = dict(n_class=CLASSES, epochs=2, max_steps_per_epoch=2,
              log=lambda *a: None)
    want = jloops.linear_probe(
        pre, jcfg, *_datasets(index_json, JaxDataset, jc.AudioConfig), **kw)
    got = loops.linear_probe(
        params_from_jax(pre), pcfg,
        *_datasets(index_json, AVDataset, pc.AudioConfig), device="cpu",
        **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


# ------------------------------------------------------ parser and runner
def _flags(parser):
    return {a.dest: (a.default, sorted(a.option_strings))
            for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    assert _flags(cli.build_parser()) == _flags(jcli.build_parser())


def _recipe_argv(name, **paths):
    text = (REPO / "recipes" / name).read_text()
    env = dict(re.findall(r"^(\w+)=\$\{\w+:-(.*)\}$", text, re.M))
    env.update(paths)
    cmd = text[text.index("python -m avsiam_tpu.cli.finetune"):]
    words = shlex.split(cmd.replace("\\\n", " ").split("\n#")[0])[3:]
    return [re.sub(r"\$(\w+)", lambda m: env[m.group(1)], w)
            for w in words if w != "$@"]


class _Stop(Exception):
    pass


def _as_dict(cfg):
    """A config's fields as plain values, dtypes by name, the mesh left
    out (the JAX main sizes it to its devices; the port runs one card)."""
    import dataclasses
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "mesh":
            continue
        if dataclasses.is_dataclass(v):
            v = _as_dict(v)
        elif f.name == "dtype":
            v = str(jnp.dtype(v)) if not isinstance(v, torch.dtype) else \
                str(v).replace("torch.", "")
        out[f.name] = v
    return out


@pytest.mark.parametrize("recipe", ["ft_vggsound.sh", "ft_audioset_20k.sh",
                                    "ft_audioset_2m.sh"])
def test_recipe_command_line_gives_the_jax_config(tmp_path, index_json,
                                                  monkeypatch, recipe):
    """The recipe's words through both parsers give the same values, and
    through both mains the same ``FinetuneConfig`` (caught where each main
    hands it to ``run_finetune``)."""
    path, csvp = index_json
    weights = tmp_path / "w.csv"
    weights.write_text(",".join(["1.0"] * 10))
    words = _recipe_argv(recipe, DATA_TRAIN=path, DATA_VAL=path,
                         LABEL_CSV=csvp, WEIGHTS=str(weights),
                         EXP_DIR=str(tmp_path / "exp"))
    ours, theirs = (vars(p.parse_args(words)) for p in
                    (cli.build_parser(), jcli.build_parser()))
    assert ours == theirs
    cfgs = {}

    def catch(which):
        def run(cfg, *a, **kw):
            cfgs[which] = cfg
            raise _Stop
        return run

    monkeypatch.setattr(jcli, "run_finetune", catch("jax"))
    monkeypatch.setattr(cli, "run_finetune", catch("port"))
    monkeypatch.setenv("AVSIAM_PLATFORM", "cpu")
    for main in (jcli.main, cli.main):
        with pytest.raises(_Stop):
            main(words)
    assert _as_dict(cfgs["port"]) == _as_dict(cfgs["jax"])
    if recipe == "ft_vggsound.sh":
        c = cfgs["port"]
        assert (c.model.label_dim, c.batch_size, c.loss, c.metrics,
                c.audio.mixup, c.audio.freqm, c.audio.timem, c.audio.noise,
                c.label_smooth, c.ftmode, c.model.dtype) == (
            309, 64, "CE", "acc", 0.5, 48, 192, True, 0.1, "mm_grad",
            torch.bfloat16)


def _tiny_argv(index_json, exp_dir, *extra):
    path, csvp = index_json
    return ["--data_train", path, "--data_val", path, "--data_eval", path,
            "--label_csv", csvp, "--n_class", "3", "--model", "tiny",
            "--n_epochs", "2", "--batch_size", "4", "--frame_source",
            "synthetic", "--max_steps_per_epoch", "2", "--exp_dir",
            str(exp_dir), "--dtype", "float32", "--target_length", "128",
            "--loss", "CE", "--metrics", "acc", "--mixup", "0.5",
            "--freqm", "8", "--timem", "16", "--noise", "True", *extra]


def test_cli_finetune_on_the_cpu(tmp_path, index_json, monkeypatch):
    """Under ``AVSIAM_PLATFORM=cpu`` the runner finetunes from a port
    pretrain params file, averages, and evaluates the best checkpoint on
    ``--data_eval``; at lr 0 a reference ``.pth``'s heads arrive as given.
    Without the variable and with no card it raises; with no process
    group a data axis of 2 is refused for the world mismatch."""
    monkeypatch.setenv("AVSIAM_PLATFORM", "cpu")
    from avsiam_tpu_torch.models.variants import pretrain_config
    pre = CAVMAEPretrain(pretrain_config("tiny"), "cpu")
    ck.save_params(str(tmp_path / "pre"), "best_audio_model", pre)
    pre_path = str(tmp_path / "pre" / "models" / "best_audio_model")
    out = cli.main(_tiny_argv(index_json, tmp_path / "exp", "--wa", "True",
                              "--wa_start", "1", "--wa_end", "2",
                              "--pretrain_path", pre_path))
    exp = tmp_path / "exp"
    for f in ("args.json", "result.csv", "metrics.jsonl", "stats_1.pickle",
              "stats_2.pickle"):
        assert (exp / f).exists(), f
    assert sorted(os.listdir(exp / "models")) == [
        "audio_model.1", "audio_model.2", "best_audio_model", "train_state.2"]
    assert [r["epoch"] for r in out["rows"]] == [1, 2]
    assert all(0.0 <= r["acc"] <= 1.0 and np.isfinite(r["train_loss"])
               for r in out["rows"])
    assert "wa_params" in out and len(out["eval_stats"]) == 3
    assert next(out["model"].parameters()).device.type == "cpu"
    # the final state, not the best checkpoint the eval loaded
    final = ck.restore_params(str(exp), "audio_model.2")
    assert all(torch.equal(t, final[k])
               for k, t in out["model"].state_dict().items())
    # a reference .pth, at lr 0: its heads are the model's
    from avsiam_tpu_torch.models.cavmae_ft import CAVMAEFinetune
    from avsiam_tpu_torch.models.variants import finetune_config
    fresh = CAVMAEFinetune(finetune_config("tiny", 3), "cpu").state_dict()
    sd = _reference_sd(fresh, 2)
    torch.save(sd, tmp_path / "ref.pth")
    cli.main(_tiny_argv(index_json, tmp_path / "exp2", "--lr", "0.0",
                        "--n_epochs", "1", "--pretrain_path",
                        str(tmp_path / "ref.pth")))
    saved = ck.restore_params(str(tmp_path / "exp2"), "audio_model.1")
    ref = {k.replace("module.", ""): t for k, t in sd.items()}
    assert torch.equal(saved["mlp_head_mm.linear.weight"],
                       ref["mlp_head_mm.1.weight"])
    monkeypatch.delenv("AVSIAM_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(_tiny_argv(index_json, tmp_path / "exp3"))
    monkeypatch.setenv("AVSIAM_PLATFORM", "cpu")
    with pytest.raises(SystemExit, match="does not match the world"):
        cli.main(_tiny_argv(index_json, tmp_path / "exp3", "--mesh_data",
                            "2"))
