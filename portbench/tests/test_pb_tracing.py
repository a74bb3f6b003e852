"""The readers of the program's spans and marks (``pb_spans`` and
``metrics/{fwd,bwd,adam}_ms.py``, ``step_idle_pct.py``) on hand-built traces and stub jobs: the numbers they
should read, the finetune phases weighted by the window's routes, and None
where a program has no spans or marks (as the parent of the readers has
none)."""

from types import SimpleNamespace

import pytest

import tiny  # noqa: F401  (puts portbench on the path)
import pb_harness as H
import pb_trace

STEMS = ("fwd_ms", "bwd_ms", "adam_ms", "step_idle_pct")
MS = 1_000_000  # ns


def _trace(device, host):
    tr = object.__new__(pb_trace.Trace)
    tr.device = sorted(device, key=lambda r: r[1])
    tr.host = list(host)
    return tr


def _read(stem, ctx):
    return H.load_module(H.reader("metrics", f"{stem}.x")).read(ctx)


def _ctx(job, trace=None, steps=(0, 1)):
    return SimpleNamespace(job=job, trace=trace,
                           window=SimpleNamespace(span_steps=list(steps)))


class _Step:
    def __init__(self, phases):
        self.phases = phases

    def phase_ms(self):
        return self.phases


PRETRAIN = {"step": {"fwd.contrast": 100.0, "bwd.contrast": 200.0,
                     "adam.contrast": 3.0, "fwd.mae": 40.0, "bwd.mae": 80.0,
                     "adam.mae": 2.0}}
FINETUNE = {"av": {"zero": 1.0, "fwd": 90.0, "bwd": 170.0, "adam": 1.0},
            "a": {"zero": 1.0, "fwd": 50.0, "bwd": 90.0, "adam": 1.0},
            "v": {"zero": 1.0, "fwd": 30.0, "bwd": 70.0, "adam": 1.0}}


def test_pretrain_phases():
    ctx = _ctx(SimpleNamespace(step_fn=_Step(PRETRAIN)))
    assert _read("fwd_ms", ctx) == 140.0
    assert _read("bwd_ms", ctx) == 280.0
    assert _read("adam_ms", ctx) == 5.0


def test_finetune_phases_weighted_by_the_window_routes():
    """Routes 2:1:1 ('av', 'a', 'v'): each phase's mean over the branch
    graphs at those weights; 'zero' counts with Adam."""
    job = SimpleNamespace(step_fn=_Step(FINETUNE),
                          branches=["av", "a", "av", "v"] * 3)
    ctx = _ctx(job)
    assert _read("fwd_ms", ctx) == pytest.approx((2 * 90 + 50 + 30) / 4)
    assert _read("bwd_ms", ctx) == pytest.approx((2 * 170 + 90 + 70) / 4)
    assert _read("adam_ms", ctx) == pytest.approx(2.0)
    # a branch the window never routed to weighs nothing
    job.branches = ["a"] * 5
    assert _read("fwd_ms", ctx) == pytest.approx(50.0)


def test_host_spans_and_idle_inside_the_step():
    """Two steps: the device busy 0-10 and 14-20 and 22-30 ms; the host in
    ``avsiam.step`` 9-12 (launch 10-11) and 19-23 (launch 20-22.5), and
    in the benchmark's own code 12-14. Idle 10-14 and 20-22 of the 30 ms
    span; 10-12 and 20-22 of it inside a step."""
    device = [("k", 0, 10 * MS), ("k", 14 * MS, 20 * MS),
              ("gemm", 22 * MS, 30 * MS)]
    host = [("avsiam.step", 9 * MS, 12 * MS),
            ("avsiam.step.launch", 10 * MS, 11 * MS),
            ("aten::rand", 12 * MS, 14 * MS),
            ("avsiam.step", 19 * MS, 23 * MS),
            ("avsiam.step.launch", 20 * MS, int(22.5 * MS))]
    ctx = _ctx(SimpleNamespace(), _trace(device, host))
    assert _read("step_idle_pct", ctx) == pytest.approx(100 * 4 / 30)
    idle = H.load_module(H.reader("metrics", "idle_pct.x")).read(ctx)
    assert idle == pytest.approx(100 * 6 / 30)
    assert _read("step_idle_pct", ctx) <= idle


def test_none_without_spans_or_marks():
    """A program with no ``phase_ms`` or no marks, a trace with no
    ``avsiam.*`` span, and an untraced run all read None."""
    device = [("k", 0, 10 * MS), ("k", 12 * MS, 20 * MS)]
    bare = _trace(device, [("aten::copy_", 9 * MS, 13 * MS)])
    cases = [_ctx(SimpleNamespace(step_fn=object()), bare),
             _ctx(SimpleNamespace(step_fn=_Step({}))),
             _ctx(SimpleNamespace(step_fn=_Step({"step": {}}))),
             _ctx(SimpleNamespace(step_fn=None)),
             _ctx(SimpleNamespace(), None, ())]
    for ctx in cases:
        for stem in STEMS:
            assert _read(stem, ctx) is None, stem


def test_every_cell_reports_the_new_metrics():
    """Each of the four cells lists the four quantities under its suffix,
    each moving that cell's clip rate."""
    for workload, suffix, moves in (
            ("base-pretrain-b64", "pretrain", "pretrain_clips_per_s"),
            ("huge-pretrain-b64", "pretrain", "pretrain_clips_per_s"),
            ("base-ft-vggsound-b64", "finetune", "finetune_clips_per_s"),
            ("base-ft-as20k-b4", "finetune_b4", "finetune_clips_per_s.b4")):
        per_layer = {m["name"]: m for m in H.load_cell(workload).per_layer}
        for stem in STEMS:
            assert per_layer[f"{stem}.{suffix}"]["moves"] == moves
