"""The pretraining runner of the port. Parity surface:
src/run_cavmae_pretrain_base.py, through ``avsiam_tpu/cli/pretrain.py``,
whose flags it takes, so the recipes' command lines run unchanged
(``recipes/pretrain_audioset.sh``).

On the card (the default; the graphed step):
  python -m avsiam_tpu_torch.cli.pretrain --data-train idx.json \
      --n-epochs 1 --batch-size 64 --frame_source synthetic \
      --max_steps_per_epoch 8 --exp-dir ./exp/smoke

On the CPU (the plain versions of the kernels, the eager step): the same
with ``AVSIAM_PLATFORM=cpu`` in the environment.

Data-parallel, one process a card (``--batch-size`` is the global batch,
which the world must divide):
  torchrun --standalone --nproc_per_node=N -m avsiam_tpu_torch.cli.pretrain \
      <the same flags>
or on each process the JAX-named flags, ``--num_processes N --process_id r
--coordinator_address host:port`` (``recipes/pretrain_audioset_multihost.sh``
passes them); under ``AVSIAM_PLATFORM=cpu`` the processes run on the CPU
over gloo.
"""

from __future__ import annotations

import argparse
import ast

import torch

from avsiam_tpu_torch.cli.common import (add_common_args,
                                         audio_config_from_args,
                                         balance_weights_from_args,
                                         dataset_from_args, dump_args,
                                         mesh_from_args, optimizer_from_args,
                                         platform_device, setup_wandb,
                                         torch_dtype)
from avsiam_tpu_torch.configs import PretrainConfig, replace
from avsiam_tpu_torch.models.variants import pretrain_config
from avsiam_tpu_torch.parallel.dist import is_main_process
from avsiam_tpu_torch.parallel.mesh import local_batch
from avsiam_tpu_torch.train.loops import run_pretrain


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("avsiam-tpu-torch pretrain")
    add_common_args(p, ft=False)
    p.add_argument("--contrast_loss_weight", type=float, default=0.01)
    p.add_argument("--mae_loss_weight", type=float, default=3.0)
    p.add_argument("--masking_ratio", type=float, default=0.75)
    p.add_argument("--masking_ratio_a", type=float, default=0.75)
    p.add_argument("--mask_mode", type=str, default="unstructured",
                   choices=["unstructured", "time", "freq", "tf"])
    p.add_argument("--mmixed_impl", type=str, default="exact",
                   choices=["padded", "exact", "bucketed", "packed",
                            "tconcat"])
    p.add_argument("--pretrain_path", type=str, default="None")
    # inert reference flags, accepted so the reference recipe's command
    # line parses (cav_mae_base.py:673-676, :312-314)
    p.add_argument("--norm_pix_loss", type=ast.literal_eval, default=False,
                   help="no-op: commented out in the reference model")
    p.add_argument("--tr_pos", type=ast.literal_eval, default=False,
                   help="no-op in CAVMAE_BASE")
    p.add_argument("--probe_data_train", type=str, default=None)
    p.add_argument("--probe_data_val", type=str, default=None)
    p.add_argument("--frame_use", type=int, default=-1,
                   help="pin the training frame index (-1 = random of 10, "
                        "the reference behavior)")
    p.add_argument("--val_interval", type=int, default=1,
                   help="validate every N epochs (always on the last; "
                        "1 = reference behavior)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest train_state checkpoint")
    p.add_argument("--weight_file", type=str, default=None,
                   help="CSV of per-sample balance weights (with --bal bal)")
    return p


def _load_init_params(args, cfg: PretrainConfig):
    """Initial parameters, or None. ``--pretrain_path`` names a timm ViT
    ``.pth`` (the reference's default start, surgically adapted for audio:
    cav_mae_base.py:236-303; the decoder keeps a fresh init from seed 0) or
    a params file a pretrain run of the port saved."""
    path = args.pretrain_path
    if not path or path == "None":
        return None
    if path.endswith(".pth"):
        from avsiam_tpu_torch.models.cavmae import CAVMAEPretrain
        from avsiam_tpu_torch.utils.torch_import import (
            build_pretrain_from_timm, load_torch_checkpoint)
        fresh = CAVMAEPretrain(cfg.model, "cpu",
                               torch.Generator().manual_seed(0)).state_dict()
        sd = build_pretrain_from_timm(
            load_torch_checkpoint(path), fresh, depth=cfg.model.vit.depth,
            num_audio_tokens=cfg.model.vit.num_audio_tokens)
        print(f"initialized pretrain trunk from timm checkpoint {path}")
        return sd
    from avsiam_tpu_torch.utils.checkpoint import restore_params_from_path
    sd = restore_params_from_path(path, map_location="cpu")
    print(f"initialized pretrain params from {path}")
    return sd


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = platform_device()
    mesh = mesh_from_args(args)
    local_batch(args.batch_size, mesh.data)  # the world must divide it
    if is_main_process():
        dump_args(args, args.exp_dir)
    setup_wandb(args)
    model_cfg = pretrain_config(args.model, dtype=torch_dtype(args.dtype),
                                attn_impl=args.attn_impl,
                                mmixed_impl=args.mmixed_impl,
                                mlp_impl=args.mlp_impl)
    # the audio token grid follows --target_length (the reference fixes
    # 1024)
    model_cfg = replace(model_cfg, vit=replace(
        model_cfg.vit, audio_length=args.target_length))
    mel, im_res = model_cfg.vit.mel_bins, model_cfg.vit.img_size
    cfg = PretrainConfig(
        model=model_cfg,
        audio=audio_config_from_args(args, train=True, num_mel_bins=mel),
        opt=optimizer_from_args(args), batch_size=args.batch_size,
        n_epochs=args.n_epochs, masking_ratio=args.masking_ratio,
        masking_ratio_a=args.masking_ratio_a, mask_mode=args.mask_mode,
        contrast_loss_weight=args.contrast_loss_weight,
        mae_loss_weight=args.mae_loss_weight,
        n_print_steps=args.n_print_steps, seed=args.seed,
        exp_dir=args.exp_dir, save_model=bool(args.save_model),
        keep_train_states=args.keep_train_states,
        train_state_every=args.train_state_every,
        val_interval=args.val_interval)

    def dataset(path, train, **kw):
        return dataset_from_args(args, path, train=train, num_mel_bins=mel,
                                 im_res=im_res, **kw)

    train_ds = dataset(args.data_train, True, frame_use=args.frame_use)
    val_ds = dataset(args.data_val, False) if args.data_val else None
    probe_train = (dataset(args.probe_data_train, True)
                   if args.probe_data_train else None)
    probe_val = (dataset(args.probe_data_val, False)
                 if args.probe_data_val else None)
    weights = balance_weights_from_args(args, len(train_ds))
    out = run_pretrain(cfg, train_ds, val_ds,
                       probe_train_ds=probe_train, probe_val_ds=probe_val,
                       probe_n_class=args.n_class,
                       init_params=_load_init_params(args, cfg),
                       balance_weights=weights, resume=args.resume,
                       max_steps_per_epoch=args.max_steps_per_epoch,
                       # read now: the rank-0 print mesh_from_args set up
                       log=print, device=device)
    print("pretrain done:", {k: out[k] for k in ("best_epoch",)
                             if k in out})
    return out


if __name__ == "__main__":
    main()
