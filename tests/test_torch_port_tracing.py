"""The port's tracing (``utils/profiling.py``) on the CPU: the spans, the
phase marks off the card, and the runners' ``--trace_dir``.

- ``annotate`` is one shared no-op context while no profiler records, and
  a span the profiler keeps while one does;
- an eager pretrain step and an eager finetune step at the tiny preset are
  each an ``avsiam.step`` span;
- ``PhaseMarks`` marks nothing off the card, and a body given marks or
  None gives the eager step's bits;
- one tiny epoch of each loop under ``trace_dir`` writes a Chrome trace of
  its steps: ``avsiam.loop.data_wait`` and ``avsiam.loop.step`` (the step's
  ``avsiam.step`` inside), neither nested in the other, each wait
  holding the batch's ``avsiam.data.transform``, and the capture counters
  in the log;
- both runners take ``--trace_dir`` and ``--trace-dir``.

The graphs' marks, their ``phase_ms()`` and the capture counters on the
card are in ``tests/test_torch_port_cuda.py``.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avsiam_tpu_torch import configs as pc
from avsiam_tpu_torch.cli import finetune as cli_ft
from avsiam_tpu_torch.cli import pretrain as cli_pt
from avsiam_tpu_torch.data.dataset import AVDataset
from avsiam_tpu_torch.models.variants import finetune_config, pretrain_config
from avsiam_tpu_torch.train import finetune as ft
from avsiam_tpu_torch.train import loops
from avsiam_tpu_torch.train import pretrain as ppre
from avsiam_tpu_torch.utils import profiling

B, CLASSES = 2, 3
TINY = pretrain_config("tiny", dtype=torch.float32).vit


def _names(prof):
    return [e.name for e in prof.events()]


def _pretrain_cfg(**kw):
    return pc.PretrainConfig(model=pretrain_config("tiny",
                                                   dtype=torch.float32),
                             batch_size=B, **kw)


def _ft_cfg(**kw):
    return pc.FinetuneConfig(
        model=finetune_config("tiny", label_dim=CLASSES, dtype=torch.float32,
                              num_eval_frames=2),
        batch_size=B, loss="CE", ftmode="mm_grad", **kw)


def _batch(seed=0, frames_dim=False):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((B, TINY.audio_length, TINY.mel_bins), generator=g)
    v = torch.randn((B, 3, TINY.img_size, TINY.img_size), generator=g)
    y = torch.softmax(torch.randn((B, CLASSES), generator=g), dim=-1)
    return (a, v[:, None], y) if frames_dim else (a, v)


# ------------------------------------------------------------- annotate
def test_annotate_is_one_no_op_without_a_profiler():
    """Off: the same shared context for every name, and entering it makes
    no op. On: a span the profiler keeps, nested spans in it."""
    assert not torch.autograd._profiler_enabled()
    off = profiling.annotate("avsiam.a")
    assert off is profiling.annotate("avsiam.b")
    assert not isinstance(off, torch.autograd.profiler.record_function)
    with off:
        torch.ones(2).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("avsiam.outer"):
            with profiling.annotate("avsiam.inner"):
                torch.ones(2).sum()
    names = _names(prof)
    assert names.count("avsiam.outer") == names.count("avsiam.inner") == 1
    # nothing was kept from before the profiler started
    assert "avsiam.a" not in names and "avsiam.b" not in names


@pytest.mark.parametrize("kind", ["pretrain", "finetune"])
def test_eager_step_is_one_step_span(kind):
    """At the tiny preset an eager step under the profiler shows one
    ``avsiam.step`` and none of the graphed step's children."""
    if kind == "pretrain":
        cfg = _pretrain_cfg()
        state = ppre.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
        step = ppre.make_pretrain_step(cfg)
        args = (_batch(), torch.Generator().manual_seed(1), 1e-4)
    else:
        cfg = _ft_cfg()
        state = ft.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
        step = ft.make_finetune_step(cfg)
        args = (_batch(frames_dim=True), 1e-4, 0.9)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, *args)
    names = _names(prof)
    assert names.count("avsiam.step") == 1
    assert not [n for n in names if n.startswith("avsiam.step.")]


# ---------------------------------------------------------------- marks
def test_phase_marks_do_nothing_off_the_card():
    for marks in (profiling.PhaseMarks(), profiling.PhaseMarks("cpu")):
        for name in ("start", "fwd", "bwd", "adam"):
            marks.mark(name)
        assert marks.names == [] and marks.stamps is None
        assert marks.ms() == {}
    profiling.no_mark("start")
    # the graphed steps read no phases before a capture
    assert ppre.make_graphed_pretrain_step(_pretrain_cfg()).phase_ms() == {}
    assert ft.make_graphed_finetune_step(_ft_cfg()).phase_ms() == {}


def _same_bits(x, y):
    return x.shape == y.shape and torch.equal(x, y)


@pytest.mark.parametrize("marks", [None, "marks"], ids=["none", "marks"])
@pytest.mark.parametrize("kind", ["pretrain", "finetune"])
def test_body_with_or_without_marks_is_the_eager_step(kind, marks):
    """The body given ``marks=None`` (or marks, which record nothing here),
    after what a caller does before it, gives the eager step's metrics,
    parameters and Adam moments bit for bit."""
    marks = profiling.PhaseMarks() if marks else None
    runs = []
    for eager in (True, False):
        g = torch.Generator().manual_seed(0)
        if kind == "pretrain":
            cfg = _pretrain_cfg()
            state = ppre.init_state(cfg, g, "cpu")
            a, v = _batch()
            draws = ppre.draw_step_masks(cfg.model, B,
                                         torch.Generator().manual_seed(1),
                                         "cpu")
            if eager:
                _, out = ppre.make_pretrain_step(cfg)(state, (a, v), None,
                                                      1e-3, draws=draws)
            else:
                state.lr.fill_(1e-3)
                out = ppre.pretrain_step_body(cfg, state, a, v, *draws,
                                              marks=marks)
        else:
            cfg = _ft_cfg()
            state = ft.init_state(cfg, g, "cpu")
            batch = _batch(frames_dim=True)
            if eager:
                _, out = ft.make_finetune_step(cfg)(state, batch, 1e-3, 0.1)
            else:
                state.set_lr(1e-3, cfg)
                state.model.zero_grad(set_to_none=True)
                out = {"loss": ft.finetune_step_body(cfg, state, *batch, "a",
                                                     marks=marks)}
        moments = [st[k] for opt in state.optimizers().values()
                   for st in opt.state.values()
                   for k in ("exp_avg", "exp_avg_sq")]
        runs.append((out, list(state.model.parameters()), moments))
    assert marks is None or marks.names == []
    (oe, pe, me), (ob, pb, mb) = runs
    assert oe.keys() == ob.keys()
    assert all(_same_bits(oe[k], ob[k]) for k in oe)
    assert len(me) == len(mb) > 0
    assert all(map(_same_bits, pe, pb)) and all(map(_same_bits, me, mb))


# ---------------------------------------------------------- the loops
@pytest.fixture
def datasets(tmp_path):
    idx = tmp_path / "idx.json"
    idx.write_text('{"data": [%s]}' % ", ".join(
        '{"wav": "/fake/%d.wav", "labels": "/m/%d"}' % (i, i % 2)
        for i in range(14)))
    labels = tmp_path / "labels.csv"
    labels.write_text("index,mid,display_name\n0,/m/0,a\n1,/m/1,b\n"
                      "2,/m/2,c\n")
    audio = pc.AudioConfig(target_length=TINY.audio_length,
                           num_mel_bins=TINY.mel_bins)
    return tuple(AVDataset(str(idx), audio, label_csv=str(labels),
                           n_class=CLASSES, mode=mode,
                           frame_source="synthetic", im_res=TINY.img_size,
                           num_frames=2) for mode in ("train", "eval"))


def _spans(events, name):
    return [(e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
            if e.get("name") == name and e.get("ph") == "X"]


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("kind", ["pretrain", "finetune"])
def test_trace_dir_writes_the_loop_spans(kind, tmp_path, datasets):
    """One tiny CPU epoch of seven steps under ``trace_dir``: one Chrome
    trace holding steps 2-4, each an ``avsiam.loop.step`` with its
    ``avsiam.step`` inside and the wait for its batch before it, no wait
    nested in a step nor a step in a wait, each wait holding its batch's
    ``avsiam.data.transform``, and the capture counters logged at the
    epoch's end."""
    train, _ = datasets
    logs = []
    common = dict(n_epochs=1, n_print_steps=1000, save_model=False,
                  exp_dir=str(tmp_path / "exp"))
    if kind == "pretrain":
        cfg = _pretrain_cfg(audio=pc.AudioConfig(
            target_length=TINY.audio_length, num_mel_bins=TINY.mel_bins),
            **common)
        run = loops.run_pretrain
    else:
        cfg = _ft_cfg(audio=pc.AudioConfig(
            target_length=TINY.audio_length, num_mel_bins=TINY.mel_bins),
            **common)
        run = loops.run_finetune
    out = run(cfg, train, max_steps_per_epoch=7, log=logs.append,
              device="cpu", trace_dir=str(tmp_path / "trace"))
    assert out["timing"]["epochs"][0]["steps"] == 7
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    steps = _spans(events, "avsiam.loop.step")
    waits = _spans(events, "avsiam.loop.data_wait")
    inner = _spans(events, "avsiam.step")
    assert len(steps) == len(inner) == 3 and len(waits) == 3
    assert all(any(_inside(s, o) for o in steps) for s in inner)
    for w in waits:
        for s in steps:
            assert not _inside(w, s) and not _inside(s, w)
            assert w[1] <= s[0] or s[1] <= w[0]  # apart in time
    for w in waits:
        assert any(_inside(t, w)
                   for t in _spans(events, "avsiam.data.transform"))
    assert [m for m in logs if m.startswith("graph.captures ")]


@pytest.mark.parametrize("spelling", ["--trace_dir", "--trace-dir"])
@pytest.mark.parametrize("cli", [cli_pt, cli_ft], ids=["pretrain",
                                                      "finetune"])
def test_runners_take_trace_dir(cli, spelling):
    parser = cli.build_parser()
    assert parser.parse_args([]).trace_dir is None
    assert parser.parse_args([spelling, "/tmp/t"]).trace_dir == "/tmp/t"


def test_counters_start_as_numbers():
    """``COUNTERS`` holds the capture count and seconds, which only a
    capture (on the card) writes."""
    assert set(profiling.COUNTERS) == {"graph.captures", "graph.capture_s"}
    assert isinstance(profiling.COUNTERS["graph.captures"], int)
    assert profiling.COUNTERS["graph.capture_s"] >= 0.0
    assert np.isfinite(profiling.COUNTERS["graph.capture_s"])
