"""The port stands alone: ``avsiam_tpu_torch`` and ``chip_smoke.py`` import
no JAX, flax, optax, scikit-learn (the card's host has none) and nothing
of the JAX package ``avsiam_tpu``.

Two checks: no import statement of the port's sources names those modules;
and, in a fresh interpreter whose import system refuses them, every module
of the port (``parallel/`` and the retrieval modules among them) imports,
a tiny CPU forward and two-pass pretrain step run, a finetune step of each
routing branch runs, the classification statistics and the retrieval
metrics are computed, the distributed helpers run as one process
without a group, the tensor-parallel state round trip and refusals
(``parallel/``, ``utils/weights.py``) run, and the audio-only model's
forward, a ToMe block and the memory probe run.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "sklearn", "avsiam_tpu")

SCRIPT = r'''
import importlib, importlib.abc, importlib.util, math, pkgutil, sys
import numpy as np

BLOCKED = %r
for name in list(sys.modules):  # e.g. loaded by a site hook
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]


class RefusingLoader(importlib.abc.Loader):
    def create_module(self, spec):
        raise ImportError(f"refused: {spec.name}")

    def exec_module(self, module):
        raise ImportError(f"refused: {module.__name__}")


class Refuse(importlib.abc.MetaPathFinder):
    """A blocked module has a spec with no origin, so that a probe of
    whether it is installed (torch's optimizer asks for scikit-learn's
    spec) passes, and an import of it raises."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            return importlib.util.spec_from_loader(name, RefusingLoader())
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
from avsiam_tpu_torch.eval.metrics import calculate_stats, mean_ap
from avsiam_tpu_torch.train import finetune as ft
fcfg = pc.FinetuneConfig(model=pc.CAVMAEFTConfig(
    vit=vit, label_dim=5, num_eval_frames=2), batch_size=6)
fstate = ft.init_state(fcfg, gen, device="cpu")
y = (torch.rand((6, 5), generator=gen) < 0.4).float()
fstep = ft.make_finetune_step(fcfg)
for u in (0.9, 0.1, 0.4):  # the fused, the audio and the video loss
    fstate, fm = fstep(fstate, (a, v[:, None], y), 1e-4, u)
    assert math.isfinite(float(fm["loss"]))
assert fstate.branches == {"av": 1, "a": 1, "v": 1}
logits = ft.make_ft_eval_step(fcfg)(
    fstate.model, (a, torch.stack([v, v], dim=1), y))
stats = calculate_stats(torch.sigmoid(logits).mean(dim=1).numpy(),
                        y.numpy())
assert 0.0 <= mean_ap(stats) <= 1.0
from avsiam_tpu_torch.configs import MeshConfig
from avsiam_tpu_torch.eval.retrieval import retrieval_metrics
from avsiam_tpu_torch.parallel import dist as pdist
from avsiam_tpu_torch.parallel.mesh import make_mesh
info = pdist.initialize_multihost()
assert info["process_count"] == 1 and not pdist.active(), info
assert make_mesh(MeshConfig()).data == 1
assert pdist.gather_eval_outputs(np.arange(5), 3).tolist() == [0, 1, 2]
assert pdist.average_across_processes({"x": 2.5}) == {"x": 2.5}
from avsiam_tpu_torch.parallel.mesh import tp_refusal
from avsiam_tpu_torch.utils.weights import gather_state_dict, shard_state_dict
sd = state.model.state_dict()
back = gather_state_dict([shard_state_dict(sd, r, 2) for r in range(2)])
assert all(torch.equal(back[k], v) for k, v in sd.items())
assert tp_refusal(2, cfg.model) is None and tp_refusal(3, cfg.model)
feats = np.random.RandomState(0).randn(6, 4)
assert retrieval_metrics(feats, feats)["R1"] == 1.0
shapes = chip_smoke.main_path_shapes(chip_smoke.bench_config(), 8)
attn, mlp, ln = shapes.attn, shapes.mlp, shapes.ln
assert sum(attn.values()) == sum(mlp.values()) == 130
assert sum(ln.values()) == 130 + 8 + 2 + 1  # norm1s, final norms, decoder
from avsiam_tpu_torch.cli import memory_probe
from avsiam_tpu_torch.models import CAVMAEFTAudio
from avsiam_tpu_torch.models.layers import ModalityBlock
ao = CAVMAEFTAudio(vit, 5, modality_specific_depth=1, device="cpu")
assert ao.forward_pred(a).shape == (6, 5)
blk = ModalityBlock(128, 2, 4.0, True, 1e-5, torch.float32, "auto", "erf",
                    "auto", "cpu")
x, keep = blk(torch.randn((2, 24, 128), generator=gen), "a", None, 5)
assert x.shape == (2, 24, 128) and (~keep).sum().item() == 10
import os
os.environ["AVSIAM_PLATFORM"] = "cpu"
probe = memory_probe.main(["--model", "tiny", "--batch-size", "2",
                           "--steps", "1", "--dtype", "float32"])
assert probe["params_million"] > 0 and probe["memory"] is None, probe
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
