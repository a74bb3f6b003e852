"""What the port's command-line runners share: argparse -> configs, the
datasets, the args.json dump, the device.

Counterpart of ``avsiam_tpu/cli/common.py``: ``add_common_args`` takes every
flag name and default of the JAX package's, so the recipes' command lines
parse unchanged. The JAX package's persistent XLA compile cache has no
counterpart here. The device: ``AVSIAM_PLATFORM=cpu`` runs a runner on the
CPU (the plain PyTorch versions of the kernels), the counterpart of
``apply_platform_override``; without it the runner runs on the card
(``device.resolve_device``, which raises where there is none). The mesh and
process flags: ``mesh_from_args`` makes the process group (torchrun's
environment or the JAX-named flags, ``parallel/dist.py``) and checks the
mesh against it (``parallel/mesh.py``); a 'model' axis above 1 is refused
(ROADMAP A10b).
"""

from __future__ import annotations

import argparse
import ast
import json
import os

import torch

from avsiam_tpu_torch.configs import AudioConfig, OptimizerConfig
from avsiam_tpu_torch.data.dataset import AVDataset
from avsiam_tpu_torch.device import resolve_device


def platform_device() -> torch.device:
    """The runners' device: the CPU under ``AVSIAM_PLATFORM=cpu``, else the
    card (raising where there is none). Another value is refused."""
    plat = os.environ.get("AVSIAM_PLATFORM", "").strip().lower()
    if plat not in ("", "cpu", "cuda", "gpu"):
        raise SystemExit(f"AVSIAM_PLATFORM={plat!r}: the port runs on 'cpu' "
                         f"or the card ('cuda', the default)")
    return resolve_device("cpu" if plat == "cpu" else "cuda")


def add_common_args(p: argparse.ArgumentParser, ft: bool = False):
    """Flag names mirror the reference runners (run_cavmae_pretrain_base.py:
    47-105 uses dashed names; run_cavmae_ft_base.py:62-141 underscored).
    Both spellings are accepted here."""
    def arg(*names, **kw):
        p.add_argument(*names, **kw)

    sep = "_" if ft else "-"
    arg(f"--data{sep}train", dest="data_train", type=str, default="")
    arg(f"--data{sep}val", dest="data_val", type=str, default="")
    arg(f"--data{sep}eval", dest="data_eval", type=str, default=None)
    arg(f"--label{sep}csv", dest="label_csv", type=str, default=None)
    arg("--n_class", type=int, default=527)
    arg("--model", type=str, default="cav-mae-base")
    arg("--dataset", type=str, default="audioset")
    arg("--dataset_mean", type=float, default=-5.081)
    arg("--dataset_std", type=float, default=4.4849)
    arg("--target_length", type=int, default=1024)
    arg("--noise", type=ast.literal_eval, default=False)
    arg(f"--exp{sep}dir", dest="exp_dir", type=str, default="./exp")
    arg("--lr", "--learning-rate", dest="lr", type=float, default=1e-4)
    arg("-b", "--batch-size", "--batch_size", dest="batch_size", type=int,
        default=12)
    arg("-w", "--num_workers", type=int, default=2)
    arg("--n-epochs", "--n_epochs", dest="n_epochs", type=int, default=10)
    arg("--metrics", type=str, default="mAP", choices=["mAP", "acc"])
    arg("--loss", type=str, default="BCE", choices=["BCE", "CE"])
    arg("--lrscheduler_start", type=int, default=10)
    arg("--lrscheduler_step", type=int, default=5)
    arg("--lrscheduler_decay", type=float, default=0.5)
    # the adaptive-lr path and the reference's parsed-but-inert flags, so
    # the recipes' command lines parse unchanged
    arg("--lr_adapt", type=ast.literal_eval, default=False,
        help="ReduceLROnPlateau(mode=max, factor=0.5, patience=lr_patience) "
             "instead of MultiStepLR (traintest_ft_base.py:99-104)")
    arg("--lr_patience", type=int, default=1 if ft else 2,
        help="epochs to wait before halving lr under --lr_adapt")
    arg("--warmup", type=ast.literal_eval, default=True,
        help="no-op: parsed but never used by the reference either "
             "(run_cavmae_ft_base.py:88)")
    arg("--optim", type=str, default="adam", choices=["sgd", "adam"],
        help="no-op: the reference parses this but hard-codes Adam in both "
             "loops (traintest_cavmae_base.py:64-66, traintest_ft_base.py:78)")
    arg("--save_model", type=ast.literal_eval, default=True,
        help="save per-epoch audio_model.{e} checkpoints "
             "(traintest_cavmae_base.py:232)")
    arg("--keep_train_states", type=int, default=1,
        help="trailing train_state.{e} resume checkpoints to keep (resume "
             "reads only the newest; <=0 keeps all)")
    arg("--train_state_every", type=int, default=1,
        help="save the resume train_state every N epochs (final epoch "
             "always saved; 1 = per-epoch, the reference behavior)")
    arg("--wandb", type=int, default=0,
        help="enable wandb logging (project 'uavm', rank 0 only)")
    arg("--model_name", type=str, default="",
        help="wandb run name (run_cavmae_ft_base.py:157)")
    arg("--n-print-steps", "--n_print_steps", dest="n_print_steps", type=int,
        default=100)
    arg("--mixup", type=float, default=0.0)
    arg("--bal", type=str, default=None)
    arg("--freqm", type=int, default=0)
    arg("--timem", type=int, default=0)
    arg("--seed", type=int, default=87)
    arg("--frame_source", type=str, default="frames",
        choices=["frames", "video", "synthetic", "synthetic_paired"])
    arg("--max_steps_per_epoch", type=int, default=None,
        help="cap steps per epoch (smoke runs)")
    arg("--dtype", type=str, default="bfloat16",
        choices=["bfloat16", "float32"])
    arg("--attn_impl", type=str, default="auto",
        choices=["auto", "pallas", "xla"])
    arg("--mlp_impl", type=str, default="auto",
        choices=["auto", "dense", "remat_g", "remat_all", "fused", "fbwd",
                 "fres", "lnfres"])
    # the JAX package's device-mesh and multi-process flags
    # (mesh_from_args); under torchrun its environment names the world
    arg("--mesh_data", type=int, default=-1,
        help="mesh 'data' axis size; -1 = every process")
    arg("--mesh_model", type=int, default=1,
        help="mesh 'model' axis size (tensor parallelism)")
    arg("--num_processes", type=int, default=None,
        help="total process count (WORLD_SIZE equivalent)")
    arg("--process_id", type=int, default=None,
        help="this process's id (RANK equivalent)")
    arg("--coordinator_address", type=str, default=None,
        help="host:port of process 0 (MASTER_ADDR:PORT equivalent)")
    return p


def mesh_from_args(args):
    """Initialise the process group where the run asks for one and resolve
    the mesh every runner trains over, the counterpart of the JAX
    package's ``mesh_from_args`` (torchrun + init_distributed_mode,
    run_cavmae_pretrain_base.py:114 / utils.py:283-299): rank-0 printing
    installed, the mesh printed. The mesh is checked before any group
    comes up, so a 'model' axis (A10b) is refused at once."""
    from avsiam_tpu_torch.configs import MeshConfig
    from avsiam_tpu_torch.parallel.dist import (initialize_multihost,
                                                setup_rank0_printing)
    from avsiam_tpu_torch.parallel.mesh import make_mesh
    mesh_cfg = MeshConfig(data=args.mesh_data, model=args.mesh_model)
    if mesh_cfg.model != 1:
        make_mesh(mesh_cfg)  # raises, naming A10b
    info = initialize_multihost(
        coordinator_address=args.coordinator_address,
        num_processes=args.num_processes, process_id=args.process_id)
    setup_rank0_printing()
    mesh = make_mesh(mesh_cfg)
    print(f"mesh: data={mesh.data} model={mesh.model} "
          f"processes={info['process_count']}")
    return mesh


def audio_config_from_args(args, train: bool,
                           num_mel_bins: int = 128) -> AudioConfig:
    return AudioConfig(
        target_length=args.target_length, num_mel_bins=num_mel_bins,
        norm_mean=args.dataset_mean, norm_std=args.dataset_std,
        freqm=args.freqm if train else 0, timem=args.timem if train else 0,
        mixup=args.mixup if train else 0.0,
        noise=bool(args.noise) if train else False)


def optimizer_from_args(args) -> OptimizerConfig:
    if getattr(args, "optim", "adam") == "sgd":
        # as the reference: --optim is accepted, and both loops build
        # torch.optim.Adam whatever it says
        print("warning: --optim sgd accepted but ignored (the reference "
              "hard-codes Adam in its loops; so do we)")
    return OptimizerConfig(
        lr=args.lr, lrscheduler_start=args.lrscheduler_start,
        lrscheduler_step=args.lrscheduler_step,
        lrscheduler_decay=args.lrscheduler_decay,
        lr_adapt=bool(getattr(args, "lr_adapt", False)),
        lr_patience=getattr(args, "lr_patience", 2))


def dataset_from_args(args, path: str, train: bool, label_smooth: float = 0.0,
                      num_mel_bins: int = 128, im_res: int = 224,
                      num_frames: int = 10, frame_use: int = -1) -> AVDataset:
    return AVDataset(path, audio_config_from_args(args, train, num_mel_bins),
                     label_csv=args.label_csv, n_class=args.n_class,
                     mode="train" if train else "eval",
                     frame_source=args.frame_source, im_res=im_res,
                     num_frames=num_frames, frame_use=frame_use,
                     label_smooth=label_smooth if train else 0.0)


def dump_args(args, exp_dir: str):
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "args.json"), "w") as f:
        json.dump({k: v for k, v in vars(args).items()
                   if isinstance(v, (int, float, str, bool, type(None)))},
                  f, indent=1)


def torch_dtype(name: str) -> torch.dtype:
    """The compute dtype of ``--dtype`` (the JAX package's ``jnp_dtype``)."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def setup_wandb(args, project: str = "uavm"):
    """--wandb: ``MetricsLogger`` attaches wandb when WANDB_PROJECT is set;
    'uavm' is the reference's project (run_cavmae_pretrain_base.py:118)."""
    if not getattr(args, "wandb", False):
        return
    os.environ.setdefault("WANDB_PROJECT", project)
    if getattr(args, "model_name", None):
        os.environ.setdefault("WANDB_NAME", args.model_name)


def balance_weights_from_args(args, n_samples: int):
    """Per-sample balanced-sampling weights, or None.

    As the reference: only the literal ``--bal bal`` turns balanced
    sampling on (run_cavmae_ft_base.py:184; the recipes pass the string
    "None" when off), and it needs ``--weight_file``, one weight per
    training sample (a short file would never draw the tail, a long one
    would draw indices past the end)."""
    if args.bal == "bal":
        if not args.weight_file:
            raise SystemExit("--bal requires --weight_file (per-sample "
                             "balance weights CSV; scripts/gen_weights.py)")
        import numpy as np
        w = np.atleast_1d(np.loadtxt(args.weight_file, delimiter=","))
        if w.ndim != 1 or len(w) != n_samples:
            raise SystemExit(
                f"--weight_file {args.weight_file}: {w.shape} weights for "
                f"{n_samples} training samples — must be one weight per "
                "sample (regenerate with scripts/gen_weights.py)")
        return w
    if args.bal not in (None, "", "None", "none", "False"):
        print(f"warning: --bal {args.bal!r} != 'bal'; unbalanced sampling "
              "(reference semantics: only 'bal' activates)")
    if args.weight_file:
        print("warning: --weight_file given without --bal bal; weighted "
              "sampling is OFF")
    return None
