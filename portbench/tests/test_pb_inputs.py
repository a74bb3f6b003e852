"""The inputs made from the seed: the same seed gives the same inputs, the
finetune routes hold the recipe's mix in every block, the compared steps
take every branch, and no module of the harness or of the reference loads
JAX or the JAX package; the reference and the yardstick load nothing of
the program."""

import ast
import itertools
import subprocess
import sys

import pytest
import torch

import tiny
import pb_harness as H
import pb_weights

ft_job = H.load_job("finetune")
pre_job = H.load_job("pretrain")
SEEDS = (0, 7, 2 ** 31 + 11, 2 ** 33 + 5)


@pytest.mark.parametrize("seed", SEEDS)
def test_routes_hold_the_mix_in_every_block(seed):
    cell = tiny.cell("base-ft-vggsound-b64")
    routes = list(itertools.islice(ft_job.route_blocks(cell.traffic, seed), 400))
    for i in range(0, 400, 4):
        assert sorted(routes[i:i + 4]) == ["a", "av", "av", "v"]
    again = list(itertools.islice(ft_job.route_blocks(cell.traffic, seed), 400))
    assert routes == again


def test_routes_differ_by_seed():
    cell = tiny.cell("base-ft-vggsound-b64")
    runs = {tuple(itertools.islice(ft_job.route_blocks(cell.traffic, s), 40))
            for s in SEEDS}
    assert len(runs) > 1


@pytest.mark.parametrize("seed", SEEDS[2:])
def test_same_seed_same_inputs(seed):
    cell = tiny.cell("base-ft-vggsound-b64")
    one = ft_job.Job(cell, seed, device="cpu", program=False)
    two = ft_job.Job(cell, seed, device="cpu", program=False)
    for (b1, r1), (b2, r2) in zip(one.compared, two.compared):
        assert r1 == r2
        assert all(torch.equal(x, y) for x, y in zip(b1, b2))
    # every compared step a distinct batch, each branch once a round
    assert len({id(b[0]) for b, _ in one.compared}) == len(one.compared)
    rounds = [[br for _, br in one.compared[i:i + 3]]
              for i in range(0, len(one.compared), 3)]
    assert all(sorted(r) == ["a", "av", "v"] for r in rounds)
    assert all(r == rounds[0] for r in rounds)
    spec = one.spec
    w1, w2 = pb_weights.make(spec, seed, "cpu"), pb_weights.make(spec, seed, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    w3 = pb_weights.make(spec, seed + 1, "cpu")
    assert not torch.equal(w1["vit.blocks.0.attn.qkv.weight"],
                           w3["vit.blocks.0.attn.qkv.weight"])


def test_pretrain_draws_per_seed():
    cell = tiny.cell("base-pretrain-b64")
    a = pre_job.Job(cell, 2 ** 32 + 3, device="cpu", program=False)
    b = pre_job.Job(cell, 2 ** 32 + 3, device="cpu", program=False)
    for (_, (d1, d2)), (_, (e1, e2)) in zip(a.compared, b.compared):
        assert torch.equal(d1["perm_a"], e1["perm_a"])
        assert torch.equal(d2["noise_v"], e2["noise_v"])
        assert sorted(d1["perm_a"].tolist()) == list(range(4))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in H.HERE.rglob("*.py") if "tests" not in p.parts)
YARDSTICK = ("pb_reference.py", "pb_weights.py", "pb_check.py", "pb_counts.py",
             "pb_trace.py", "pb_readers.py")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(H.HERE)))
def test_no_jax_import(path):
    found = set(_imports(path))
    assert not found & set(H.FORBIDDEN), found
    if path.name in YARDSTICK:
        assert "avsiam_tpu_torch" not in found


def test_forbidden_names_compare_whole():
    assert "avsiam_tpu_torch" not in H.FORBIDDEN
    code = ("import sys; sys.path[:0] = [%r, %r]; import pb_harness as H; "
            "import avsiam_tpu_torch.train.pretrain, avsiam_tpu_torch.train."
            "finetune; print(H.forbidden_modules())"
            % (str(H.HERE), str(H.ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r]; import pb_reference, "
            "pb_weights, pb_check, pb_counts; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'avsiam_tpu', 'avsiam_tpu_torch', 'jax', 'flax', 'optax'}))"
            % str(H.HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
