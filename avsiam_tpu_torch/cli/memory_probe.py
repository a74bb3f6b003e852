"""Memory and parameter probe: builds the pretrain model, reports its
parameter and optimizer-state counts, and the card's peak memory over a few
eager pretrain steps on constant inputs.

Counterpart of ``avsiam_tpu/cli/memory_probe.py`` (the reference's
``src/gpu_memory.py``), with its flags and its JSON keys:

    python -m avsiam_tpu_torch.cli.memory_probe --model cav-mae-base \\
        --batch-size 8 --steps 3

prints one line, ``{"model", "params_million", "optimizer_state_million",
"batch_size", "memory"}``. ``memory`` is ``utils/profiling.py:
device_memory_stats`` of the card after the steps (the process's peak:
init, state and steps); None on the CPU, which only
``AVSIAM_PLATFORM=cpu`` selects (``cli/common.py:platform_device``).
"""

from __future__ import annotations

import argparse
import json

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("avsiam-tpu memory probe (PyTorch port)")
    p.add_argument("--model", type=str, default="cav-mae-base")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    return p


def count_params(params) -> int:
    return sum(p.numel() for p in params)


def optimizer_state_size(opt: torch.optim.Optimizer) -> int:
    """The values a masked Adam holds as the JAX package's optax state
    counts them: both moments of each parameter it steps and one step
    count. (torch's capturable Adam keeps a step tensor per parameter, a
    layout detail the count leaves out.)"""
    params = [p for g in opt.param_groups for p in g["params"]]
    return 2 * count_params(params) + 1


def main(argv=None):
    from avsiam_tpu_torch.cli.common import platform_device, torch_dtype
    from avsiam_tpu_torch.configs import OptimizerConfig, PretrainConfig
    from avsiam_tpu_torch.models.variants import pretrain_config
    from avsiam_tpu_torch.train.pretrain import init_state, make_pretrain_step
    from avsiam_tpu_torch.utils.profiling import device_memory_stats

    args = build_parser().parse_args(argv)
    device = platform_device()
    model_cfg = pretrain_config(args.model, dtype=torch_dtype(args.dtype))
    B = args.batch_size
    cfg = PretrainConfig(model=model_cfg, opt=OptimizerConfig(),
                         batch_size=B)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_state(cfg, gen, device)
    vit = model_cfg.vit
    a = torch.ones((B, vit.audio_length, vit.mel_bins), device=device)
    v = torch.ones((B, 3, vit.img_size, vit.img_size), device=device)
    n_params = count_params(state.model.parameters())
    n_opt = sum(optimizer_state_size(o) for o in (state.opt1, state.opt2))
    step = make_pretrain_step(cfg)
    for _ in range(args.steps):
        state, metrics = step(state, (a, v), gen, 1e-4)
    float(metrics["loss"])  # waits for the steps
    out = {
        "model": args.model,
        "params_million": round(n_params / 1e6, 3),
        "optimizer_state_million": round(n_opt / 1e6, 3),
        "batch_size": B,
        "memory": device_memory_stats(device),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
