"""The tiny cells the CPU tests run: the configurations and traffic of the
benchmark's files at the program's test widths, float32 or bf16 compute."""

import copy
import sys
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import pb_harness  # noqa: E402

TINY_VIT = {"dim": 32, "depth": 2, "num_heads": 2, "patch_size": 16,
            "img_size": 32, "audio_length": 128, "mel_bins": 32}
TINY_DECODER = {"dim": 16, "depth": 1, "num_heads": 2}


def cell(workload: str, dtype: str = "float32", batch: int = 4,
         **traffic) -> SimpleNamespace:
    """The benchmark's cell ``workload`` at tiny widths: its configuration's
    every other setting, its traffic with ``batch`` and a short ring."""
    c = pb_harness.load_cell(workload)
    cfg = copy.deepcopy(c.config)
    cfg["vit"].update(TINY_VIT)
    cfg["decoder"].update(TINY_DECODER)
    cfg["dtype"] = dtype
    t = dict(c.traffic, batch=batch, ring=12, **traffic)
    return SimpleNamespace(**dict(vars(c), config=cfg, traffic=t))
