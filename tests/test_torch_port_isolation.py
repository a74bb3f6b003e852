"""The port stands alone: ``avsiam_tpu_torch`` and ``chip_smoke.py`` import
no JAX, flax, optax and nothing of the JAX package ``avsiam_tpu``.

Two checks: no import statement of the port's sources names those modules;
and, in a fresh interpreter whose import system refuses them, every module
of the port imports and a tiny CPU forward and two-pass step run.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "avsiam_tpu")

SCRIPT = r'''
import importlib, importlib.abc, math, pkgutil, sys

BLOCKED = %r
for name in list(sys.modules):  # e.g. loaded by a site hook
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"refused: {name}")
        return None


sys.meta_path.insert(0, Refuse())
import torch
import avsiam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(avsiam_tpu_torch.__path__,
                                                "avsiam_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from avsiam_tpu_torch import configs as pc
from avsiam_tpu_torch.train.pretrain import init_state, make_pretrain_step

vit = pc.ViTConfig(dim=128, depth=1, num_heads=2, img_size=48,
                   audio_length=128, mel_bins=32)
cfg = pc.PretrainConfig(model=pc.CAVMAEConfig(
    vit=vit, decoder=pc.DecoderConfig(dim=128, depth=1, num_heads=4),
    mmixed_impl="exact"), batch_size=6)
gen = torch.Generator().manual_seed(0)
state = init_state(cfg, gen, device="cpu")
a = torch.randn((6, 128, 32), generator=gen)
v = torch.randn((6, 3, 48, 48), generator=gen)
out = state.model(a, v, mae_loss_weight=1.0, contrast_loss_weight=0.01,
                  generator=gen)
assert math.isfinite(float(out[0].detach()))
step = make_pretrain_step(cfg)
for _ in range(2):
    state, metrics = step(state, (a, v), gen, 1e-3)
assert all(math.isfinite(float(x)) for x in metrics.values()), metrics
shapes = chip_smoke.main_path_shapes(chip_smoke.bench_config(), 8)
attn, mlp, ln = shapes.attn, shapes.mlp, shapes.ln
assert sum(attn.values()) == sum(mlp.values()) == 130
assert sum(ln.values()) == 130 + 8 + 2 + 1  # norm1s, final norms, decoder
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not loaded, loaded
print("ISOLATED", len(names))
''' % (BLOCKED,)


def _sources():
    return sorted((REPO / "avsiam_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in BLOCKED, (path, mod)


def test_port_runs_with_jax_imports_refused():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED" in proc.stdout
