"""The port's recipes (``avsiam_tpu_torch/recipes/*.sh``) against the JAX
package's (``recipes/*.sh``, ``scripts/soak_paired.sh``).

Each recipe runs under bash with ``python`` and ``torchrun`` replaced by
stubs on the PATH that record their arguments and run nothing, so that
bash itself expands the variables, arrays and defaults. Every ``-m
avsiam_tpu_torch.cli.*`` call must parse with the port's parser, and its
namespace must equal the JAX parser's namespace of the matching call of
the JAX recipe, in order: the same flags, values and defaults, apart from
the module and the launcher (torchrun's own flags; for the multi-node
recipe the rendezvous, which torchrun's environment gives in the port and
the JAX-named flags in the JAX package's).
"""

import importlib
import json
import os
import pathlib
import subprocess

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "avsiam_tpu_torch" / "recipes"
PAIRS = {  # port recipe -> the JAX package's
    "pretrain_audioset.sh": "recipes/pretrain_audioset.sh",
    "pretrain_audioset_multihost.sh": "recipes/pretrain_audioset_multihost.sh",
    "ft_audioset_20k.sh": "recipes/ft_audioset_20k.sh",
    "ft_audioset_2m.sh": "recipes/ft_audioset_2m.sh",
    "ft_vggsound.sh": "recipes/ft_vggsound.sh",
    "smoke_synthetic.sh": "recipes/smoke_synthetic.sh",
    "soak_paired.sh": "scripts/soak_paired.sh",
}
# the rendezvous of the multi-node recipes: torchrun's environment in the
# port, the JAX-named flags in the JAX package (the world's size is named
# on both sides)
RENDEZVOUS = ("coordinator_address", "process_id")
STUB = """#!/bin/sh
python3 -c 'import json, os, sys
with open(os.environ["RECIPE_CALLS"], "a") as f:
    f.write(json.dumps([os.path.basename(sys.argv[1])] + sys.argv[2:]) + "\\n")
' "$0" "$@"
"""


def _calls(script: pathlib.Path, tmp: pathlib.Path):
    """[(module, argv, launcher words)] of the runner calls ``script``
    makes, in order, under the stubs; ``tmp`` holds the stubs, the record
    and the recipes' working directories."""
    stubs = tmp / "bin"
    stubs.mkdir(exist_ok=True)
    for name in ("python", "torchrun"):
        (stubs / name).write_text(STUB)
        (stubs / name).chmod(0o755)
    record = tmp / f"{script.relative_to(REPO)}.calls".replace("/", "_")
    work = tmp / "work"
    work.mkdir(exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("DATA_TRAIN", "DATA_VAL", "LABEL_CSV", "EXP_DIR",
                        "PRETRAIN", "WEIGHTS", "MODEL", "EPOCHS", "N",
                        "NVAL", "B", "RESUME", "SEED", "NNODES",
                        "NODE_RANK", "NPROC_PER_NODE", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PATH=f"{stubs}{os.pathsep}{env['PATH']}",
               RECIPE_CALLS=str(record), WORK=str(work),
               EXP=str(work / "soak"),
               # a two-process world on each side
               NPROC_PER_NODE="2", JAX_COORDINATOR_ADDRESS="h:29400",
               JAX_NUM_PROCESSES="2", JAX_PROCESS_ID="0")
    subprocess.run(["bash", str(script)], env=env, check=True, cwd=tmp,
                   stdin=subprocess.DEVNULL, capture_output=True, timeout=60)
    out = []
    for line in record.read_text().splitlines():
        words = json.loads(line)
        if "-m" not in words:  # the recipes' inline python scripts
            continue
        i = words.index("-m")
        out.append((words[i + 1], words[i + 2:], words[:i]))
    return out


def _parse(module: str, argv):
    return vars(importlib.import_module(module).build_parser()
                .parse_args(argv))


@pytest.mark.parametrize("recipe", sorted(PAIRS))
def test_port_recipe_matches_the_jax_recipe(recipe, tmp_path):
    ours = _calls(PORT / recipe, tmp_path)
    theirs = _calls(REPO / PAIRS[recipe], tmp_path)
    assert ours and len(ours) == len(theirs), (ours, theirs)
    for (mod, argv, launcher), (jmod, jargv, _) in zip(ours, theirs):
        assert mod.startswith("avsiam_tpu_torch.cli.")
        assert jmod == mod.replace("avsiam_tpu_torch.", "avsiam_tpu.")
        got, want = _parse(mod, argv), _parse(jmod, jargv)
        # the port's own --trace_dir, which no recipe passes
        assert got.pop("trace_dir", None) is None
        if recipe == "pretrain_audioset_multihost.sh":
            assert launcher[0] == "torchrun"
            assert launcher[launcher.index("--nproc_per_node") + 1] == "2"
            assert got["num_processes"] == want["num_processes"] == 2
            for k in RENDEZVOUS:
                assert got.pop(k) is None and want.pop(k) is not None
        else:
            assert launcher == ["python"]
        assert got == want


def test_every_port_recipe_is_paired():
    assert sorted(p.name for p in PORT.glob("*.sh")) == sorted(PAIRS)
