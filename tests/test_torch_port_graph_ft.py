"""The port's finetune step and eval forwards as CUDA graphs, on the CPU:
the step body against the eager step, the graphed step's and forwards'
bookkeeping (warm-up, one capture a branch or signature, replays, static
buffers) run with stand-in graphs, and their refusal of the CPU. The
captures and replays themselves run on the card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py`` phase FTG); the JAX
package holds the graphed step's bookkeeping in
``tests/test_torch_port_finetune.py``.

A stand-in graph (``_EagerGraph``) is what the capture would record: its
``replay`` runs the captured function again, eagerly, writing the
capture's outputs in place. With it the graphed objects' own code runs on
the CPU end to end but for the capture call, and must give the eager
step's and forwards' bits: every loss, parameter, Adam moment and step
count, and every output, exactly.

Tiny geometry (``test_torch_port_common.VIT``: dim 128, 2 heads, depth
1), float32, numpy-seeded inputs.
"""

import contextlib

import numpy as np
import pytest
import torch

from avsiam_tpu_torch import configs as pc
from avsiam_tpu_torch.cli import retrieval as pret
from avsiam_tpu_torch.models.cavmae_ft import CAVMAEFinetune
from avsiam_tpu_torch.train import finetune as ft
from avsiam_tpu_torch.train import graphs
from avsiam_tpu_torch.train import param_groups as pg
from avsiam_tpu_torch.train import pretrain as ppre
from test_torch_port_common import VIT, batch, configs

B, CLASSES, FRAMES = 3, 10, 2
# each branch three times (warm-up, capture, replay), interleaved, so that
# a branch replays after another's capture
SEQUENCE = (0.9, 0.1, 0.9, 0.4, 0.1, 0.9, 0.4, 0.1, 0.4)


def _cfg(ftmode="mm_grad", loss="BCE", **kw):
    model = pc.CAVMAEFTConfig(vit=pc.ViTConfig(**VIT), label_dim=CLASSES,
                              num_eval_frames=FRAMES)
    return pc.FinetuneConfig(model=model, opt=pc.OptimizerConfig(lr=1e-3),
                             batch_size=B, head_lr=4.0, mm_lr=2.0,
                             ftmode=ftmode, loss=loss, **kw)


def _state(cfg, seed=0):
    return ft.init_state(cfg, torch.Generator().manual_seed(seed), "cpu")


def _batch(seed=0, frames=1):
    rs = np.random.RandomState(seed)
    a = rs.randn(B, VIT["audio_length"], VIT["mel_bins"])
    v = rs.randn(B, frames, 3, VIT["img_size"], VIT["img_size"])
    y = (rs.rand(B, CLASSES) < 0.3).astype(np.float64)
    return tuple(torch.from_numpy(x.astype(np.float32)) for x in (a, v, y))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This module's steps are many small tensor ops: one intra-op thread
    for them (restored after), so that on a loaded host the idle threads'
    waits do not multiply each op's cost. Both sides of every comparison
    run under it, so no result depends on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _EagerGraph:
    """Stands in for a captured CUDA graph on the CPU: ``replay`` runs the
    captured function eagerly and writes its outputs into ``out``, the
    tensors the capture returned."""

    def __init__(self, fn, out=None):
        self.fn, self.out = fn, out

    def replay(self):
        got = self.fn()
        if self.out is None:
            return
        for dst, src in zip(graphs._tensors(self.out),
                            graphs._tensors(got)):
            dst.copy_(src)


@contextlib.contextmanager
def stand_in_graphs_on():
    """Within the block ``Captures.capture`` records the function without
    running it (a forward's outputs are made by running it once, as a
    capture's are allocated), and ``warm_up`` runs its call on the current
    device; yields the list of the captures made."""
    made = []

    def capture(self, fn, device):
        out = fn() if isinstance(self, graphs.GraphedForward) else None
        made.append(self.what)
        return _EagerGraph(fn, out), out, {}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs.Captures, "capture", capture)
        mp.setattr(graphs, "warm_up", lambda fn, device: fn())
        yield made


@pytest.fixture
def stand_in_graphs():
    with stand_in_graphs_on() as made:
        yield made


def _bind_on_the_cpu(step, state, batch):
    """What the graphed step's first call takes (its state and static
    copies of the batch), without its refusal of the CPU."""
    step.state, step.batch = state, tuple(x.clone() for x in batch)


def _bind_forward_on_the_cpu(forward, model):
    """What a graphed forward's first call takes (its model), without its
    refusal of the CPU: every call then captures or replays."""
    forward.model = model


def _adam(state):
    """{name: (exp_avg, exp_avg_sq, step)} of the state's Adam."""
    out = {}
    for name, p in state.model.named_parameters():
        st = state.opt.state.get(p, {})
        out[name] = tuple(st.get(k) for k in ("exp_avg", "exp_avg_sq",
                                              "step"))
    return out


def _assert_same_states(got, want):
    for (name, pw), pg_ in zip(want.model.named_parameters(),
                               got.model.parameters(), strict=True):
        assert torch.equal(pg_, pw), name
    adam_g, adam_w = _adam(got), _adam(want)
    for name, w in adam_w.items():
        for x, y in zip(adam_g[name], w):
            assert (x is None and y is None) or torch.equal(x, y), name
    assert got.step == want.step and got.branches == want.branches


# ------------------------------------------------------------ the body
@pytest.mark.parametrize("ftmode,u", [("mm_grad", 0.9), ("mm_grad", 0.1),
                                      ("mm_grad", 0.4), ("joint_av", None)],
                         ids=["av", "a", "v", "joint_av"])
def test_body_equals_the_eager_step(ftmode, u):
    """``finetune_step_body`` after the rates and cleared gradients, as a
    caller runs it, gives ``make_finetune_step``'s loss, parameters,
    moments and step counts bit for bit, in each branch and outside
    'mm_grad'."""
    cfg = _cfg(ftmode)
    batch = _batch()
    eager = _state(cfg)
    eager, m = ft.make_finetune_step(cfg)(eager, batch, 2e-3, u)
    body = _state(cfg)
    body.set_lr(2e-3, cfg)
    body.model.zero_grad(set_to_none=True)
    loss = ft.finetune_step_body(cfg, body, *batch,
                                 ft.step_branch(cfg, 0, u))
    if u is not None:
        body.branches[ft.route(u)] += 1
    body.step += 1
    assert torch.equal(loss, m["loss"])
    _assert_same_states(body, eager)


def test_step_branch_selects_the_graph():
    """Under 'mm_grad' a draw selects the branch (and so the graph) by
    ``route``, the draw of the step count when none is given; every other
    mode has one graph, keyed None, and draws nothing."""
    cfg = _cfg()
    for u, want in ((0.9, "av"), (0.5000001, "av"), (0.5, "v"),
                    (0.25, "v"), (0.2499999, "a"), (0.0, "a")):
        assert ft.step_branch(cfg, 7, u) == want
    for n in range(8):
        assert ft.step_branch(cfg, n) == ft.route(ft.draw_route(cfg.seed, n))
    assert ft.step_branch(_cfg("joint_av"), 3, 0.9) is None
    assert ft.gated(cfg) and not ft.gated(_cfg(parity_optimizer=False))
    assert not ft.gated(_cfg("joint_av"))


# -------------------------------------------------- the graphed step
@pytest.mark.parametrize("case", ["gated", "plain", "joint_av"])
def test_graphed_step_equals_the_eager_step(stand_in_graphs, case):
    """The graphed step's own code over a branch sequence (each branch
    warmed up, captured, replayed, interleaved), stand-in graphs for the
    captures, against the eager step from the same state and draws: the
    same bits in every loss, parameter, moment and step count, and after
    each call in every ``.grad`` (None where eager's is); one capture a branch
    (one outside 'mm_grad'); state.branches counted; under the parity
    optimizer each branch's graph steps the parameters its loss reaches
    (``ft_touched``), otherwise every parameter."""
    cfg = _cfg("joint_av" if case == "joint_av" else "mm_grad",
               parity_optimizer=case == "gated")
    us = (None,) * 4 if case == "joint_av" else SEQUENCE
    batches = [_batch(seed=10 + i) for i in range(len(us))]
    lrs = [1e-3 * 0.9 ** i for i in range(len(us))]
    eager, graphed = _state(cfg), _state(cfg)
    estep = ft.make_finetune_step(cfg)
    gstep = ft.make_graphed_finetune_step(cfg)
    _bind_on_the_cpu(gstep, graphed, batches[0])
    for u, b, lr in zip(us, batches, lrs):
        eager, me = estep(eager, b, lr, u)
        graphed, mg = gstep(graphed, b, lr, u)
        assert torch.equal(mg["loss"], me["loss"])
        for (name, pe), pg_ in zip(eager.model.named_parameters(),
                                   graphed.model.parameters()):
            assert (pe.grad is None and pg_.grad is None) or torch.equal(
                pg_.grad, pe.grad), name
    _assert_same_states(graphed, eager)
    keys = [None] if case == "joint_av" else list(ft.BRANCHES)
    assert sorted(gstep.graphs, key=str) == sorted(keys, key=str)
    assert stand_in_graphs == ["the finetune step"] * len(keys)
    names = [n for n, _ in graphed.model.named_parameters()]
    for key in keys:
        want = [case != "gated" or pg.ft_touched(n, key) for n in names]
        assert gstep.touched[key] == want
    if case != "joint_av":
        assert graphed.branches == dict.fromkeys(ft.BRANCHES, 3)


def test_graphed_step_takes_copies_and_refuses_what_it_cannot_replay(
        stand_in_graphs):
    """The static buffers take a copy of each batch (never the caller's
    tensors); another state, or a batch of another shape or dtype, is
    refused before anything runs."""
    cfg = _cfg()
    state = _state(cfg)
    step = ft.make_graphed_finetune_step(cfg)
    first = _batch(seed=1)
    _bind_on_the_cpu(step, state, first)
    ids = [id(s) for s in step.batch]
    for i, u in enumerate((0.9, 0.9)):
        b = _batch(seed=2 + i)
        state, _ = step(state, b, 1e-3, u)
        assert [id(s) for s in step.batch] == ids
        assert all(torch.equal(s, x) and s is not x
                   for s, x in zip(step.batch, b))
    a, v, y = b
    n = state.step
    for bad in ((a[:2], v[:2], y[:2]), (a.double(), v, y)):
        with pytest.raises(ValueError, match="captured for"):
            step(state, bad, 1e-3, 0.9)
    with pytest.raises(ValueError, match="state of its first call"):
        step(_state(cfg), b, 1e-3, 0.9)
    assert state.step == n


def test_graphed_step_refuses_the_cpu():
    """No fallback: a state on the CPU is refused at the graphed step's
    first call, which runs nothing eagerly."""
    cfg = _cfg()
    state = _state(cfg)
    before = [p.detach().clone() for p in state.model.parameters()]
    with pytest.raises(RuntimeError, match="CUDA device"):
        ft.make_graphed_finetune_step(cfg)(state, _batch(), 1e-3, 0.9)
    assert state.step == 0 and state.branches == dict.fromkeys(
        ft.BRANCHES, 0)
    assert all(torch.equal(p, q)
               for p, q in zip(state.model.parameters(), before))


# ------------------------------------------------- the graphed forwards
def _pretrain_eval(seed=0):
    _, cfg = configs(batch=B)
    state = ppre.init_state(cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, state.model


@pytest.mark.parametrize("which", ["ft_eval", "pretrain_eval", "retrieval"])
def test_graphed_forwards_refuse_the_cpu(which):
    """Each graphed forward refuses a model on the CPU at its first call,
    computing nothing."""
    if which == "pretrain_eval":
        cfg, model = _pretrain_eval()
        a, v = (torch.from_numpy(x) for x in batch(B))
        call = lambda: ppre.make_graphed_eval_step(cfg)(  # noqa: E731
            model, (a, v), torch.Generator().manual_seed(0))
    else:
        cfg = _cfg()
        model = CAVMAEFinetune(cfg.model, "cpu")
        a, v, y = _batch(frames=FRAMES)
        if which == "ft_eval":
            call = lambda: ft.make_graphed_ft_eval_step(cfg)(  # noqa: E731
                model, (a, v, y))
        else:
            fwd = graphs.GraphedForward(pret.retrieval_features, "retrieval")
            call = lambda: fwd(model, a, v)  # noqa: E731
    with pytest.raises(RuntimeError, match="CUDA device"):
        call()


def test_ft_eval_forward_one_graph_a_signature(stand_in_graphs):
    """The graphed finetune eval step: one capture per batch shape, each
    replay the eager step's logits bit for bit, its static inputs copies of
    the batch; another model refused."""
    cfg = _cfg(ftmode_test="audioonly")
    model = CAVMAEFinetune(cfg.model, "cpu",
                           torch.Generator().manual_seed(3))
    eager = ft.make_ft_eval_step(cfg)
    graphed = ft.make_graphed_ft_eval_step(cfg)
    _bind_forward_on_the_cpu(graphed.graphed, model)
    batches = [_batch(seed=i, frames=FRAMES) for i in range(4)]
    batches.append(tuple(x[:2] for x in _batch(seed=9, frames=FRAMES)))
    for b in batches:
        got = graphed(model, b)
        assert torch.equal(got, eager(model, b))
        assert got.shape == (b[0].shape[0], 1, CLASSES)
    fwd = graphed.graphed
    assert len(fwd.graphs) == 2 and len(stand_in_graphs) == 2
    static = fwd.graphs[graphs._signature(batches[-1][0]),
                        graphs._signature(batches[-1][1])][0]
    assert all(torch.equal(s, x) and s is not x
               for s, x in zip(static, batches[-1][:2]))
    with pytest.raises(ValueError, match="model of its first call"):
        graphed(CAVMAEFinetune(cfg.model, "cpu"), batches[0])


def test_pretrain_eval_forward_draws_ahead(stand_in_graphs):
    """The pretrain eval step with its draws taken ahead
    (``draw_eval_masks``), eager and graphed, gives the metrics the model
    gives when it draws from the same generator itself, bit for bit."""
    cfg, model = _pretrain_eval(seed=2)
    eager = ppre.make_eval_step(cfg)
    graphed = ppre.make_graphed_eval_step(cfg)
    _bind_forward_on_the_cpu(graphed.graphed, model)
    for i in range(3):
        a, v = (torch.from_numpy(x) for x in batch(B, seed=i))
        with torch.no_grad():
            out = model(a, v, cfg.masking_ratio_a, cfg.masking_ratio,
                        mae_loss_weight=cfg.mae_loss_weight,
                        contrast_loss_weight=cfg.contrast_loss_weight,
                        mask_mode=cfg.mask_mode,
                        generator=ppre.step_generator(None, i, "cpu"))
        want = dict(zip(("loss", "loss_mae", "loss_mae_a", "loss_mae_v",
                         "loss_c"), out[:5]), c_acc=out[7])
        for step in (eager, graphed):
            got = step(model, (a, v), ppre.step_generator(None, i, "cpu"))
            assert got.keys() == want.keys()
            for k in want:
                assert torch.equal(got[k], want[k]), k
    assert len(graphed.graphed.graphs) == 1


def test_retrieval_forward_partial_batch_gets_its_own_graph(
        stand_in_graphs):
    """The retrieval forward and token means over batches of 3, 3, 3 and a
    partial 1: a graph for the full batches and one for the partial batch,
    every output the eager one's bits."""
    cfg = _cfg()
    model = CAVMAEFinetune(cfg.model, "cpu",
                           torch.Generator().manual_seed(5))
    fwd = graphs.GraphedForward(pret.retrieval_features, "retrieval")
    _bind_forward_on_the_cpu(fwd, model)
    for i, n in enumerate((B, B, B, 1)):
        a, v, _ = (x[:n] for x in _batch(seed=20 + i))
        got = fwd(model, a, v)
        want = pret.retrieval_features(model, a, v)
        assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
        assert got[0].shape == (n, VIT["dim"])
    assert len(fwd.graphs) == 2 and len(stand_in_graphs) == 2
