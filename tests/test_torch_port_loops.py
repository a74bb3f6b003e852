"""Port parity of the pretrain loop (``train/loops.py``).

- Bookkeeping against the JAX loop: both packages' ``make_pretrain_step``
  and ``make_eval_step`` are stubbed (pytest monkeypatch) with metrics that
  are a function of the step count and of the eval batch's place, and their
  checkpoint saves with ones that record the name and leave a marker, so
  the loops run their own code around them: the feed (the index and
  position batches each epoch's loader takes, through the real
  ``device_loader``), ``result.csv``, ``progress.pkl`` (times aside), the
  checkpoint names per epoch and what pruning leaves, and the learning rate
  of each epoch, under ``val_interval``, ``save_model``,
  ``train_state_every``, ``keep_train_states``, balanced sampling, the
  MultiStepLR schedule and ``lr_adapt``'s plateau scheduler.
- The feed against JAX's ``_epoch_loader`` on a ragged dataset: train,
  weighted, and the padded eval slab.
- The meters cover every step, and a NaN aborts within one print window.
- Real steps on the CPU, at the tiny geometry of the step tests: two epochs
  straight equal one epoch and a ``--resume`` bit for bit, in parameters,
  both Adams' moments and ``result.csv``; after a restore both Adams read
  one lr tensor, and one ``fill_`` of it (to 0) holds every parameter
  through a step of both passes.
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avsiam_tpu.train.loops as jloops
import avsiam_tpu.train.pretrain as jpt
import avsiam_tpu.utils.checkpoint as jck
from avsiam_tpu import configs as jc
from avsiam_tpu.data.dataset import AVDataset as JaxDataset
from avsiam_tpu_torch import configs as pc
from avsiam_tpu_torch.data.dataset import AVDataset
from avsiam_tpu_torch.data.pipeline import batch_generator_seed
from avsiam_tpu_torch.train import loops
from avsiam_tpu_torch.train import pretrain as ppt
from avsiam_tpu_torch.utils import checkpoint as ck
from test_torch_port_common import VIT, configs

AUDIO = dict(target_length=VIT["audio_length"], num_mel_bins=VIT["mel_bins"])


@pytest.fixture
def index_json(tmp_path):
    p = tmp_path / "idx.json"
    p.write_text('{"data": [%s]}' % ", ".join(
        '{"wav": "/fake/%d.wav", "labels": "/m/%d"}' % (i, i % 2)
        for i in range(8)))
    csvp = tmp_path / "labels.csv"
    csvp.write_text("index,mid,display_name\n0,/m/0,a\n1,/m/1,b\n2,/m/2,c\n")
    return str(p), str(csvp)


def _datasets(index_json, cls, audio_cls):
    path, csvp = index_json
    return tuple(cls(path, audio_cls(**AUDIO), label_csv=csvp, mode=mode,
                     frame_source="synthetic", im_res=VIT["img_size"],
                     num_frames=3) for mode in ("train", "eval"))


def _step_metrics(s: int):
    """A step's metrics from its step count: dyadic, so float32 sums are
    exact in both frameworks."""
    return dict(loss=1 + s / 4, loss_c=2 - s / 8, c_acc=(s % 4) / 4,
                loss_mae=s / 2, loss_mae_a=s / 4, loss_mae_v=s / 4)


def _eval_metrics(i: int):
    """The i-th eval batch's metrics (the count runs across epochs)."""
    loss = 1 + i / 8  # rising: the plateau scheduler halves the rate
    return dict(loss=loss, loss_mae=loss / 2, loss_mae_a=loss / 4,
                loss_mae_v=loss / 4, loss_c=loss / 2, c_acc=(i % 2) / 2)


def _stub_jax(monkeypatch, record):
    evals = [0]

    def make_step(model, cfg):
        def step(state, batch, rng, lr):
            s = int(state.step)
            return state._replace(step=state.step + 1), {
                k: jnp.float32(x) for k, x in _step_metrics(s).items()}
        return step

    def make_eval(model, cfg):
        def ev(params, batch, rng):
            evals[0] += 1
            return {k: jnp.float32(x)
                    for k, x in _eval_metrics(evals[0] - 1).items()}
        return ev

    def save(exp_dir, name, _):
        record["saves"].append(str(name))
        os.makedirs(os.path.join(exp_dir, "models", str(name)), exist_ok=True)

    def loader(ds, index_batches, transform, rng, **kw):
        record["feed"].append(_feed(index_batches, kw))
        return real_jax_loader(ds, index_batches, transform, rng, **kw)

    real_jax_loader = jloops.device_loader
    monkeypatch.setattr(jpt, "make_pretrain_step", make_step)
    monkeypatch.setattr(jpt, "make_eval_step", make_eval)
    monkeypatch.setattr(jloops, "save_params", save)
    monkeypatch.setattr(jck, "save_train_state", save)
    monkeypatch.setattr(jloops, "device_loader", loader)


def _stub_port(monkeypatch, record):
    evals = [0]

    def make_step(cfg):
        def step(state, batch, generator, lr):
            s = state.step
            state.step += 1
            return state, {k: torch.tensor(x, dtype=torch.float32)
                           for k, x in _step_metrics(s).items()}
        return step

    def make_eval(cfg):
        def ev(model, batch, generator):
            evals[0] += 1
            return {k: torch.tensor(x, dtype=torch.float32)
                    for k, x in _eval_metrics(evals[0] - 1).items()}
        return ev

    def save(exp_dir, name, _):
        record["saves"].append(str(name))
        path = os.path.join(exp_dir, "models", str(name))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        open(path, "wb").close()

    def loader(ds, index_batches, transform, draw_seed, **kw):
        record["feed"].append(_feed(index_batches, kw))
        record["draw_seeds"].append(draw_seed)
        return real_loader(ds, index_batches, transform, draw_seed, **kw)

    real_loader = loops.device_loader
    monkeypatch.setattr(ppt, "make_pretrain_step", make_step)
    monkeypatch.setattr(ppt, "make_eval_step", make_eval)
    monkeypatch.setattr(loops, "save_params", save)
    monkeypatch.setattr(loops, "save_train_state", save)
    monkeypatch.setattr(loops, "device_loader", loader)


def _feed(index_batches, kw):
    pos = kw.get("position_batches")
    return (kw["train"], kw["seed"],
            [np.asarray(b).tolist() for b in index_batches],
            None if pos is None else [np.asarray(b).tolist() for b in pos])


CASES = {
    # validation every second epoch (and at the last), a train state every
    # second epoch, keep one
    "val_interval": dict(n_epochs=3, val_interval=2, train_state_every=2,
                         keep_train_states=1, n_print_steps=1),
    # no per-epoch params, keep two train states, the plateau scheduler
    "lr_adapt": dict(n_epochs=4, save_model=False, keep_train_states=2,
                     n_print_steps=3, opt=dict(lr_adapt=True, lr_patience=1)),
    # no validation, balanced sampling, keep all, MultiStepLR decaying
    "no_val": dict(n_epochs=3, keep_train_states=0, n_print_steps=2,
                   weights=True, val=False,
                   opt=dict(lrscheduler_start=1, lrscheduler_step=1)),
}


def _run_loop(run_pretrain, cfgs_mod, cfg_base, datasets, exp_dir, case):
    case = dict(case)
    opt = case.pop("opt", {})
    weights = case.pop("weights", False)
    val = case.pop("val", True)
    cfg = cfgs_mod.replace(cfg_base, audio=cfgs_mod.AudioConfig(**AUDIO),
                           opt=cfgs_mod.replace(cfg_base.opt, **opt),
                           batch_size=4, exp_dir=str(exp_dir), **case)
    w = np.linspace(1.0, 2.0, len(datasets[0])) if weights else None
    kw = dict(device="cpu") if cfgs_mod is pc else {}
    return run_pretrain(cfg, datasets[0], datasets[1] if val else None,
                        balance_weights=w, max_steps_per_epoch=2,
                        log=lambda *a: None, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_bookkeeping_matches_the_jax_loop(tmp_path, index_json, monkeypatch,
                                          case):
    jcfg, pcfg = configs(batch=4)
    # the JAX loop still initialises its model: XLA attention and the dense
    # MLP compile fastest
    jcfg = jc.replace(jcfg, model=jc.replace(jcfg.model, attn_impl="xla",
                                             mlp_impl="dense"))
    jrec = dict(saves=[], feed=[])
    prec = dict(saves=[], feed=[], draw_seeds=[])
    _stub_jax(monkeypatch, jrec)
    _stub_port(monkeypatch, prec)
    jout = _run_loop(jloops.run_pretrain, jc, jcfg,
                     _datasets(index_json, JaxDataset, jc.AudioConfig),
                     tmp_path / "jax", CASES[case])
    pout = _run_loop(loops.run_pretrain, pc, pcfg,
                     _datasets(index_json, AVDataset, pc.AudioConfig),
                     tmp_path / "port", CASES[case])
    assert pout["rows"] == jout["rows"]
    assert pout["best_epoch"] == jout["best_epoch"]
    for f in ("result.csv",):
        assert ((tmp_path / "port" / f).read_text()
                == (tmp_path / "jax" / f).read_text())
    progress = []
    for d in ("jax", "port"):
        with open(tmp_path / d / "progress.pkl", "rb") as f:
            progress.append([p[:4] for p in pickle.load(f)])
    assert progress[0] == progress[1]
    assert prec["saves"] == jrec["saves"]
    assert (sorted(os.listdir(tmp_path / "port" / "models"))
            == sorted(os.listdir(tmp_path / "jax" / "models")))
    assert prec["feed"] == jrec["feed"]
    # each epoch's draws keyed on (seed, epoch)
    n = CASES[case]["n_epochs"]
    assert [s for s, f in zip(prec["draw_seeds"], prec["feed"]) if f[0]] == [
        batch_generator_seed(pcfg.seed, e) for e in range(1, n + 1)]
    lrs = [r["lr"] for r in pout["rows"]]
    if case == "lr_adapt":
        assert lrs[-1] < lrs[0]  # the plateau scheduler acted
    if case == "no_val":
        assert lrs == [pcfg.opt.lr * 0.5 ** e for e in range(n)]


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("what", ["train", "weighted", "eval"])
def test_epoch_loader_takes_the_jax_batches(monkeypatch, what):
    """On 10 samples in batches of 4: train drops the partial batch, the
    weighted draw is JAX's, and the eval slab is padded by repeating the
    last index ([8, 9, 9, 9])."""
    taken = {}

    def rec(name):
        def loader(ds, index_batches, transform, rng, **kw):
            taken[name] = _feed(index_batches, kw)
            return iter(())
        return loader

    monkeypatch.setattr(jloops, "device_loader", rec("jax"))
    monkeypatch.setattr(loops, "device_loader", rec("port"))
    ds, train = _Sized(10), what != "eval"
    w = np.arange(1.0, 11.0) if what == "weighted" else None
    jloops._epoch_loader(ds, 4, 3, 87, None, None, weights=w, train=train)
    loops._epoch_loader(ds, 4, 3, 87, None, 0, weights=w, device="cpu",
                        train=train)
    assert taken["port"] == taken["jax"]
    if what == "eval":
        assert taken["port"][2] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 9, 9]]
    else:
        assert [len(b) for b in taken["port"][2]] == [4, 4]


def _tiny_cfg(tmp_path, **kw):
    _, pcfg = configs(batch=4)
    return pc.replace(pcfg, **dict(dict(
        audio=pc.AudioConfig(**AUDIO), exp_dir=str(tmp_path / "exp")), **kw))


def test_meters_cover_every_step(tmp_path, index_json, monkeypatch):
    """With the loss forced to the step count (0, 1, 2) and a print cadence
    longer than the epoch, the epoch's average is exactly 1.0."""
    real = ppt.make_pretrain_step

    def counting_step(cfg):
        fn = real(cfg)

        def wrapped(state, batch, generator, lr):
            state, metrics = fn(state, batch, generator, lr)
            return state, dict(metrics, loss=torch.tensor(
                float(state.step - 1)))
        return wrapped

    monkeypatch.setattr(ppt, "make_pretrain_step", counting_step)
    train, _ = _datasets(index_json, AVDataset, pc.AudioConfig)
    cfg = _tiny_cfg(tmp_path, batch_size=2, n_epochs=1, n_print_steps=1000)
    out = loops.run_pretrain(cfg, train, max_steps_per_epoch=3,
                             log=lambda *a: None, device="cpu")
    assert out["rows"][0]["loss"] == 1.0
    assert out["timing"]["epochs"][0]["steps"] == 3


def test_nan_divergence_abort(tmp_path, index_json, monkeypatch):
    """A NaN loss aborts within one print window: the window's sum kept on
    the device carries it to the next fetch."""
    real = ppt.make_pretrain_step
    steps = []

    def nan_step(cfg):
        fn = real(cfg)

        def wrapped(state, batch, generator, lr):
            state, metrics = fn(state, batch, generator, lr)
            steps.append(state.step)
            return state, dict(metrics, loss=metrics["loss"] * torch.nan)
        return wrapped

    monkeypatch.setattr(ppt, "make_pretrain_step", nan_step)
    train, _ = _datasets(index_json, AVDataset, pc.AudioConfig)
    cfg = _tiny_cfg(tmp_path, batch_size=2, n_epochs=2, n_print_steps=2)
    out = loops.run_pretrain(cfg, train, max_steps_per_epoch=4,
                             log=lambda *a: None, device="cpu")
    assert out == {"diverged": True, "epoch": 1}
    assert steps == [1]  # the first print point, step 0, saw it


def _final(out):
    state = out["state"]
    params = {k: t.clone() for k, t in state.model.state_dict().items()}
    moments = [t.clone() for opt in (state.opt1, state.opt2)
               for s in opt.state.values()
               for t in (s["exp_avg"], s["exp_avg_sq"], s["step"])]
    return params, moments


def test_resume_equals_the_straight_run(tmp_path, index_json):
    """Real steps on the CPU: epoch 1, then ``resume`` to epoch 2, against
    epochs 1-2 straight: every parameter, both Adams' moments and step
    counts, and ``result.csv`` bit for bit. After the restore both Adams'
    groups hold the state's one lr tensor; filled with 0 it holds every
    parameter through a step of both passes."""
    train, val = _datasets(index_json, AVDataset, pc.AudioConfig)
    straight = _tiny_cfg(tmp_path / "s", n_epochs=2, n_print_steps=1)
    resumed = pc.replace(straight, exp_dir=str(tmp_path / "r" / "exp"))
    kw = dict(max_steps_per_epoch=2, log=lambda *a: None, device="cpu")
    s_out = loops.run_pretrain(straight, train, val, **kw)
    loops.run_pretrain(pc.replace(resumed, n_epochs=1), train, val, **kw)
    r_out = loops.run_pretrain(resumed, train, val, resume=True, **kw)
    assert r_out["timing"]["restore_s"] is not None
    assert r_out["state"].step == s_out["state"].step == 4
    (sp, sm), (rp, rm) = _final(s_out), _final(r_out)
    assert sp.keys() == rp.keys()
    assert all(torch.equal(sp[k], rp[k]) for k in sp)
    assert len(sm) == len(rm) > 0
    assert all(torch.equal(x, y) for x, y in zip(sm, rm))
    assert r_out["rows"] == s_out["rows"]
    for f in ("result.csv",):
        assert ((tmp_path / "r" / "exp" / f).read_text()
                == (tmp_path / "s" / "exp" / f).read_text())

    state = r_out["state"]
    lr = state.lr
    assert all(g["lr"] is lr for opt in (state.opt1, state.opt2)
               for g in opt.param_groups)
    fresh = ppt.init_state(straight, torch.Generator().manual_seed(3), "cpu")
    ck.restore_train_state(str(tmp_path / "r" / "exp"), "train_state.2",
                           fresh)
    assert fresh.opt1.param_groups[0]["lr"] is fresh.opt2.param_groups[0]["lr"]
    before = {k: t.clone() for k, t in fresh.model.state_dict().items()}
    step = ppt.make_pretrain_step(straight)
    a, v, _ = next(iter(loops._epoch_loader(
        train, 4, 3, straight.seed, loops.make_train_transform(
            straight.audio, im_res=VIT["img_size"]), 0, device="cpu")))
    step(fresh, (a, v), torch.Generator().manual_seed(0), 0.0)
    after = fresh.model.state_dict()
    assert all(torch.equal(t, after[k]) for k, t in before.items())
