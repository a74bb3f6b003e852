"""Port parity of the pretrain runner's pieces: the eval step, the plateau
scheduler, checkpoints, the timm import, the parser, and the CLI itself.

- ``make_eval_step`` against the JAX ``make_eval_step`` on the draws the
  JAX forward takes from the eval step's own keys (``record_draws``), in
  the 'exact' and 'padded' forms, float32, with both loss weights on. The
  JAX side runs its XLA attention and dense MLP (the kernel paths are held
  in the attention and MLP tests); the port its usual path, the plain
  versions on the CPU. Metrics to 1e-5 relative.
- ``PlateauScheduler`` against the JAX one and torch's
  ``ReduceLROnPlateau``, update for update, exactly.
- Checkpoints: round trips, the shared learning rate after a restore, the
  atomic write, pruning, and the refusal of an orbax directory.
- ``build_pretrain_from_timm`` against ``params_from_jax`` of the JAX
  ``build_pretrain_from_timm`` on one random timm-format state_dict.
- The parser against the JAX parser (every ``dest`` and default), the
  recipe's command line through both, and the runner under
  ``AVSIAM_PLATFORM=cpu``, where without it and with no card it raises.
"""

import os
import pickle
import re
import shlex
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from avsiam_tpu import configs as jc
from avsiam_tpu.cli.pretrain import build_parser as jax_build_parser
from avsiam_tpu.models import CAVMAEPretrain as JaxModel
from avsiam_tpu.train.optim import PlateauScheduler as JaxPlateau
from avsiam_tpu.train.pretrain import make_eval_step as jax_make_eval_step
from avsiam_tpu.utils.torch_import import \
    build_pretrain_from_timm as jax_build_from_timm
from avsiam_tpu_torch import configs as pc
from avsiam_tpu_torch.cli import pretrain as cli
from avsiam_tpu_torch.models.cavmae import CAVMAEPretrain
from avsiam_tpu_torch.train.optim import PlateauScheduler, plateau_scheduler
from avsiam_tpu_torch.train.pretrain import (init_state, make_eval_step,
                                             make_pretrain_step)
from avsiam_tpu_torch.utils import checkpoint as ck
from avsiam_tpu_torch.utils.torch_import import build_pretrain_from_timm
from avsiam_tpu_torch.utils.weights import params_from_jax
from test_torch_port_common import batch, configs, record_draws

REPO = Path(__file__).resolve().parents[1]
B = 6
WEIGHTS = dict(mae_loss_weight=3.0, contrast_loss_weight=0.01)


def _configs(form: str = "exact"):
    """The tiny geometry (XLA attention, dense MLP on the JAX side) in
    ``form``, with both loss weights on."""
    jcfg, pcfg = configs(batch=B)
    jcfg = jc.replace(jcfg, model=jc.replace(
        jcfg.model, attn_impl="xla", mlp_impl="dense", mmixed_impl=form),
        **WEIGHTS)
    pcfg = pc.replace(pcfg, model=pc.replace(pcfg.model, mmixed_impl=form),
                      **WEIGHTS)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def jax_params():
    """The JAX model's initial parameters at the tiny geometry (numpy)."""
    jcfg, _ = _configs()
    a, v = batch(2)
    key = jax.random.PRNGKey(0)
    return jax.device_get(jax.jit(JaxModel(jcfg.model).init)(
        {"params": key, "mask": key, "perm": key}, a, v)["params"])


# ------------------------------------------------------------ eval step
@pytest.mark.parametrize("form", ["exact", "padded"])
def test_eval_step_matches_jax(monkeypatch, jax_params, form):
    """The validation forward with the config's loss weights: every metric
    of the port's ``make_eval_step`` against the JAX one's, on the draws
    the JAX forward takes from the eval step's keys (``split(rng)``)."""
    jcfg, pcfg = _configs(form)
    model = JaxModel(jcfg.model)
    a, v = batch(B, seed=3)
    rng = jax.random.PRNGKey(5)
    want = jax.device_get(jax_make_eval_step(model, jcfg)(jax_params, (a, v),
                                                          rng))
    k_mask, k_perm = jax.random.split(rng)
    _, draws = record_draws(monkeypatch, model, jax_params, a, v,
                            WEIGHTS["mae_loss_weight"],
                            WEIGHTS["contrast_loss_weight"],
                            {"mask": k_mask, "perm": k_perm})
    port = CAVMAEPretrain(pcfg.model, "cpu")
    port.load_state_dict(params_from_jax(jax_params), strict=True)
    got = make_eval_step(pcfg)(port, (torch.from_numpy(a),
                                      torch.from_numpy(v)), None, draws=draws)
    assert set(got) == set(want)
    for k, t in got.items():
        assert not t.requires_grad  # under no_grad
        np.testing.assert_allclose(float(t), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ------------------------------------------------------ plateau scheduler
def _torch_lrs(metrics, lr, **kw):
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.Adam([p], lr=lr)
    sched = torch.optim.lr_scheduler.ReduceLROnPlateau(opt, **kw)
    out = []
    for m in metrics:
        sched.step(m)
        out.append(opt.param_groups[0]["lr"])
    return out


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("patience,cooldown,threshold_mode",
                         [(0, 0, "rel"), (2, 0, "rel"), (1, 2, "rel"),
                          (1, 0, "abs")])
def test_plateau_scheduler_matches_jax_and_torch(mode, patience, cooldown,
                                                 threshold_mode):
    """Update for update, the same rates as the JAX ``PlateauScheduler``
    and as torch's ``ReduceLROnPlateau`` on random walks with plateaus."""
    rng = np.random.RandomState(patience * 10 + cooldown)
    kw = dict(mode=mode, factor=0.5, patience=patience, cooldown=cooldown,
              threshold_mode=threshold_mode)
    for trial in range(4):
        metrics = np.cumsum(rng.randn(30) * 0.1) + rng.choice([0.0, 0.5])
        if trial % 2:
            metrics[10:20] = metrics[10]
        port, ref = PlateauScheduler(1e-3, **kw), JaxPlateau(1e-3, **kw)
        got = [port.step(m) for m in metrics]
        assert got == [ref.step(m) for m in metrics]
        assert got == _torch_lrs(metrics, 1e-3, **kw)


def test_plateau_factory_takes_the_reference_settings():
    s = plateau_scheduler(pc.OptimizerConfig(lr=1e-4, lr_adapt=True,
                                             lr_patience=1))
    assert (s.mode, s.factor, s.patience, s.lr) == ("max", 0.5, 1, 1e-4)
    assert [s.step(m) for m in (0.5, 0.4, 0.4)] == [1e-4, 1e-4, 5e-5]


# ------------------------------------------------------------ checkpoints
def _stepped_state(pcfg, steps: int = 1):
    gen = torch.Generator().manual_seed(0)
    state = init_state(pcfg, gen, device="cpu")
    a, v = (torch.from_numpy(x) for x in batch(B, seed=4))
    step = make_pretrain_step(pcfg)
    for _ in range(steps):
        state, _ = step(state, (a, v), gen, 1e-3)
    return state


def _moments(opt):
    return [t.clone() for s in opt.state.values()
            for t in (s["exp_avg"], s["exp_avg_sq"], s["step"])]


def test_train_state_round_trip_keeps_one_lr(tmp_path):
    """A saved train state restores into a fresh state: parameters, both
    Adams' moments and step counts and the step equal; both Adams read
    one lr tensor, the state's, at the saved rate; a ``fill_`` of it sets
    both; the fresh state's parameter tensors are the ones it had."""
    _, pcfg = _configs()
    state = _stepped_state(pcfg)
    state.lr.fill_(3e-4)
    ck.save_train_state(str(tmp_path), "train_state.1", state)
    assert sorted(os.listdir(tmp_path / "models")) == ["train_state.1"]
    fresh = init_state(pcfg, torch.Generator().manual_seed(1), device="cpu")
    ptrs = [p.data_ptr() for p in fresh.model.parameters()]
    lr = fresh.lr
    ck.restore_train_state(str(tmp_path), "train_state.1", fresh)
    assert [p.data_ptr() for p in fresh.model.parameters()] == ptrs
    assert fresh.step == state.step == 1
    for k, t in state.model.state_dict().items():
        assert torch.equal(t, fresh.model.state_dict()[k]), k
    for o, f in ((state.opt1, fresh.opt1), (state.opt2, fresh.opt2)):
        for x, y in zip(_moments(o), _moments(f), strict=True):
            assert torch.equal(x, y)
    groups = fresh.opt1.param_groups + fresh.opt2.param_groups
    assert all(g["lr"] is lr for g in groups)
    assert fresh.lr is lr and float(lr) == pytest.approx(3e-4)
    lr.fill_(1e-5)
    assert all(float(g["lr"]) == pytest.approx(1e-5) for g in groups)


def test_params_round_trip_and_orbax_refused(tmp_path):
    _, pcfg = _configs()
    model = CAVMAEPretrain(pcfg.model, "cpu")
    path = ck.save_params(str(tmp_path), "best_audio_model", model)
    assert path == str(tmp_path / "models" / "best_audio_model")
    for sd in (ck.restore_params(str(tmp_path), "best_audio_model"),
               ck.restore_params_from_path(path)):
        assert sd.keys() == model.state_dict().keys()
        assert all(torch.equal(sd[k], t)
                   for k, t in model.state_dict().items())
    (tmp_path / "models" / "audio_model.3").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        ck.restore_params(str(tmp_path), "audio_model.3")


def test_a_failed_save_leaves_no_file(tmp_path, monkeypatch):
    """A save that fails part-way leaves neither the real name nor its
    temporary file; the checkpoint already under the name stays."""
    _, pcfg = _configs()
    model = CAVMAEPretrain(pcfg.model, "cpu")
    ck.save_params(str(tmp_path), "audio_model.1", model)
    before = (tmp_path / "models" / "audio_model.1").read_bytes()
    real_save = torch.save

    def failing(obj, f):
        real_save(obj, f)
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", failing)
    for name in ("audio_model.1", "audio_model.2"):
        with pytest.raises(OSError, match="disk full"):
            ck.save_params(str(tmp_path), name, model)
    assert sorted(os.listdir(tmp_path / "models")) == ["audio_model.1"]
    assert (tmp_path / "models" / "audio_model.1").read_bytes() == before


@pytest.mark.parametrize("keep,left", [(1, [5]), (2, [3, 5]), (0, [1, 3, 5]),
                                       (9, [1, 3, 5])])
def test_prune_train_states(tmp_path, keep, left):
    """The ``keep`` newest ``train_state.{e}`` files stay (<= 0: all);
    other files and an orbax directory are not touched."""
    models = tmp_path / "models"
    models.mkdir()
    for e in (1, 3, 5):
        (models / f"train_state.{e}").write_bytes(b"x")
    for other in ("audio_model.1", "best_audio_model", ".train_state.7.tmp1"):
        (models / other).write_bytes(b"x")
    (models / "train_state.0").mkdir()
    ck.prune_train_states(str(tmp_path), keep)
    assert ck.train_state_epochs(str(tmp_path)) == [0] + left
    assert (models / "audio_model.1").exists()
    assert (models / ".train_state.7.tmp1").exists()


# ------------------------------------------------------------ timm import
def _timm_state_dict(dim: int, depth: int, grid: int, seed: int = 0):
    """A timm-format ViT state_dict of ``grid`` patch tokens, block 0's
    entries 'module.'-prefixed."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g)

    sd = {"patch_embed.proj.weight": r(dim, 3, 16, 16),
          "patch_embed.proj.bias": r(dim), "pos_embed": r(1, 1 + grid, dim),
          "cls_token": r(1, 1, dim), "norm.weight": r(dim),
          "norm.bias": r(dim)}
    for i in range(depth):
        p = f"blocks.{i}"
        for n in ("norm1", "norm2"):
            sd[f"{p}.{n}.weight"], sd[f"{p}.{n}.bias"] = r(dim), r(dim)
        for layer, (o, i_) in (("attn.qkv", (3 * dim, dim)),
                               ("attn.proj", (dim, dim)),
                               ("mlp.fc1", (4 * dim, dim)),
                               ("mlp.fc2", (dim, 4 * dim))):
            sd[f"{p}.{layer}.weight"], sd[f"{p}.{layer}.bias"] = r(o, i_), r(o)
    return {f"module.{k}" if k.startswith("blocks.0") else k: v
            for k, v in sd.items()}


def test_build_pretrain_from_timm_matches_jax(jax_params):
    """The surgery's state_dict equals ``params_from_jax`` of the JAX
    package's, entry for entry (the 9-token video grid resampled to the 16
    audio tokens; a 'module.' prefix stripped), and loads into the port's
    model strictly."""
    _, pcfg = _configs()
    vit = pcfg.model.vit
    sd = _timm_state_dict(vit.dim, vit.depth, vit.num_video_tokens)
    want = params_from_jax(jax_build_from_timm(
        {k: v.numpy() for k, v in sd.items()}, jax_params, depth=vit.depth,
        num_audio_tokens=vit.num_audio_tokens))
    got = build_pretrain_from_timm(sd, params_from_jax(jax_params),
                                   depth=vit.depth,
                                   num_audio_tokens=vit.num_audio_tokens)
    assert got.keys() == want.keys()
    for k, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    CAVMAEPretrain(pcfg.model, "cpu").load_state_dict(got, strict=True)


# ------------------------------------------------------ parser and runner
def _flags(parser):
    return {a.dest: (a.default, sorted(a.option_strings))
            for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    """Every flag of the JAX runner, under the same names, dest and
    default."""
    assert _flags(cli.build_parser()) == _flags(jax_build_parser())


def _recipe_argv():
    """The argument words of ``recipes/pretrain_audioset.sh``'s command,
    its variables at their defaults."""
    text = (REPO / "recipes" / "pretrain_audioset.sh").read_text()
    env = dict(re.findall(r"^(\w+)=\$\{\w+:-(.*)\}$", text, re.M))
    cmd = text[text.index("python -m avsiam_tpu.cli.pretrain"):]
    words = shlex.split(cmd.replace("\\\n", " "))[3:]
    return [re.sub(r"\$(\w+)", lambda m: env[m.group(1)], w)
            for w in words if w != "$@"]


def test_recipe_command_line_parses_as_in_jax():
    """The AudioSet pretrain recipe's command line gives the same values
    through the port's parser as through the JAX one."""
    words = _recipe_argv()
    ours, theirs = (vars(p.parse_args(words)) for p in
                    (cli.build_parser(), jax_build_parser()))
    assert ours == theirs
    assert (ours["batch_size"], ours["lr"], ours["mae_loss_weight"],
            ours["masking_ratio_a"], ours["noise"], ours["data_val"]) == (
        64, 2e-4, 0.0, 0.25, True, "/data/audioset/eval.sqlite.db")


@pytest.fixture
def index_json(tmp_path):
    p = tmp_path / "idx.json"
    p.write_text('{"data": [%s]}' % ", ".join(
        '{"wav": "/fake/%d.wav", "labels": "/m/%d"}' % (i, i % 2)
        for i in range(8)))
    csvp = tmp_path / "labels.csv"
    csvp.write_text("index,mid,display_name\n0,/m/0,a\n1,/m/1,b\n2,/m/2,c\n")
    return str(p), str(csvp)


def _tiny_argv(index_json, exp_dir, *extra):
    path, csvp = index_json
    return ["--data-train", path, "--data-val", path, "--label-csv", csvp,
            "--n_class", "3", "--model", "tiny", "--n-epochs", "1",
            "--batch-size", "4", "--frame_source", "synthetic",
            "--max_steps_per_epoch", "2", "--exp-dir", str(exp_dir),
            "--dtype", "float32", "--target_length", "128", *extra]


def test_cli_pretrain_smoke_on_the_cpu(tmp_path, index_json, monkeypatch):
    """Under ``AVSIAM_PLATFORM=cpu`` the runner trains an epoch eagerly and
    writes what the JAX runner writes, under its names."""
    monkeypatch.setenv("AVSIAM_PLATFORM", "cpu")
    out = cli.main(_tiny_argv(index_json, tmp_path / "exp"))
    exp = tmp_path / "exp"
    for f in ("args.json", "result.csv", "progress.pkl", "metrics.jsonl"):
        assert (exp / f).exists(), f
    assert sorted(os.listdir(exp / "models")) == [
        "audio_model.1", "best_audio_model", "train_state.1"]
    row = out["rows"][0]
    assert row["epoch"] == 1 and np.isfinite(row["loss"])
    assert np.isfinite(row["eval_loss"])
    with open(exp / "progress.pkl", "rb") as f:
        assert [p[:3] for p in pickle.load(f)] == [[1, 2, 1]]
    assert next(out["model"].parameters()).device.type == "cpu"


def test_cli_pretrain_needs_a_card_or_the_cpu_flag(tmp_path, index_json,
                                                   monkeypatch):
    """Without ``AVSIAM_PLATFORM`` the runner asks for the card and raises
    where there is none; with no process group, a data axis or a process
    count other than the world of one process is refused for the
    mismatch, and a 'model' axis naming tensor parallelism's module
    (A10b). Probe datasets, which the runner refused before the finetune
    model came, now run the per-epoch linear probe on the CPU."""
    monkeypatch.delenv("AVSIAM_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(_tiny_argv(index_json, tmp_path / "exp"))
    monkeypatch.setenv("AVSIAM_PLATFORM", "cpu")
    for flags, refusal in ((["--mesh_data", "2"], "does not match the world"),
                           (["--num_processes", "4"],
                            "does not match the world"),
                           (["--mesh_model", "2"], "A10b")):
        with pytest.raises(SystemExit, match=refusal):
            cli.main(_tiny_argv(index_json, tmp_path / "exp", *flags))
    out = cli.main(_tiny_argv(index_json, tmp_path / "exp2",
                              "--probe_data_train", index_json[0],
                              "--probe_data_val", index_json[0]))
    row = out["rows"][0]
    for mode in ("joint_av", "audioonly", "videoonly"):
        assert 0.0 <= row[f"probe_{mode}_mAP"] <= 1.0


def test_cli_pretrain_timm_init(tmp_path, index_json, monkeypatch):
    """``--pretrain_path`` with a timm ``.pth``: at lr 0 the saved epoch-1
    audio patch embed is the colour mean of the checkpoint's video patch
    embed, and the ``ast`` trunk equals the ``vit`` one."""
    monkeypatch.setenv("AVSIAM_PLATFORM", "cpu")
    from avsiam_tpu_torch.models.variants import vit_config
    v = vit_config("tiny")
    sd = _timm_state_dict(v.dim, v.depth, v.num_video_tokens)
    ckpt = tmp_path / "timm_tiny.pth"
    torch.save(sd, ckpt)
    cli.main(_tiny_argv(index_json, tmp_path / "exp", "--lr", "0.0",
                        "--pretrain_path", str(ckpt)))
    saved = ck.restore_params(str(tmp_path / "exp"), "audio_model.1")
    w = sd["patch_embed.proj.weight"]
    want = w.permute(0, 2, 3, 1).mean(dim=-1).reshape(v.dim, -1)
    torch.testing.assert_close(saved["vit.patch_embed_a.proj.weight"], want,
                               rtol=0, atol=1e-6)
    for k, t in saved.items():
        if k.startswith("vit."):
            assert torch.equal(saved["ast." + k[4:]], t), k

