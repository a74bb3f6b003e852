"""The finetuning runner of the port. Parity surface:
src/run_cavmae_ft_base.py, through ``avsiam_tpu/cli/finetune.py``, whose
flags it takes, so the recipes' command lines run unchanged
(``recipes/ft_vggsound.sh``, ``ft_audioset_20k.sh``, ``ft_audioset_2m.sh``).

On the card (the default), the step and the evaluations as CUDA graphs
(one graph a routing branch; ``train/loops.py``):
  python -m avsiam_tpu_torch.cli.finetune --data_train idx.json \
      --data_val idx.json --n_epochs 1 --batch_size 8 \
      --frame_source synthetic --max_steps_per_epoch 2 --exp_dir ./exp/ft

On the CPU (the plain versions of the kernels, eagerly): the same with
``AVSIAM_PLATFORM=cpu`` in the environment. Data-parallel under torchrun
or the JAX-named process flags, as ``cli/pretrain.py`` says.

``--pretrain_path`` names a reference-format ``.pth`` (a finetune or a
pretrain model's state_dict, loaded non-strictly) or a params file a
pretrain run of the port saved (its trunk and fusion layers carried over).
With ``--data_eval`` the best checkpoint is evaluated on that set at the
end.
"""

from __future__ import annotations

import argparse
import ast
import copy
import os

import torch

from avsiam_tpu_torch.cli.common import (add_common_args,
                                         add_trace_arg,
                                         audio_config_from_args,
                                         balance_weights_from_args,
                                         dataset_from_args, dump_args,
                                         mesh_from_args, optimizer_from_args,
                                         platform_device, setup_wandb,
                                         torch_dtype)
from avsiam_tpu_torch.configs import FinetuneConfig, replace
from avsiam_tpu_torch.models.variants import finetune_config
from avsiam_tpu_torch.parallel.dist import is_main_process
from avsiam_tpu_torch.parallel.mesh import local_batch
from avsiam_tpu_torch.train.loops import run_finetune


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("avsiam-tpu-torch finetune")
    add_common_args(p, ft=True)
    add_trace_arg(p)
    p.add_argument("--ftmode", type=str, default="mm_grad")
    p.add_argument("--ftmode_test", type=str, default=None)
    p.add_argument("--head_lr", type=float, default=50.0)
    p.add_argument("--mm_lr", type=float, default=100.0)
    p.add_argument("--freeze_base", type=ast.literal_eval, default=False)
    p.add_argument("--label_smooth", type=float, default=0.1)
    p.add_argument("--pretrain_path", type=str, default="None")
    p.add_argument("--wa", type=ast.literal_eval, default=False)
    p.add_argument("--wa_start", type=int, default=1)
    p.add_argument("--wa_end", type=int, default=10)
    p.add_argument("--weight_file", type=str, default=None,
                   help="CSV of per-sample balance weights (with --bal)")
    # inert reference flags, accepted so the reference recipe's command
    # line parses: skip_frame_agg is read only in the reference's dead
    # ensemble block (run_cavmae_ft_base.py:283-369); dis_w / dis_w_2 are
    # parsed and never read
    p.add_argument("--skip_frame_agg", type=ast.literal_eval, default=False,
                   help="no-op: only used in the reference's dead code")
    p.add_argument("--dis_w", type=float, default=0.0,
                   help="no-op: parsed but never read by the reference")
    p.add_argument("--dis_w_2", type=float, default=0.0,
                   help="no-op: parsed but never read by the reference")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest train_state checkpoint")
    p.add_argument("--parity_optimizer", type=ast.literal_eval, default=True,
                   help="under mm_grad, Adam skips every parameter the "
                        "routed loss does not reach (the reference's torch "
                        "semantics); False, or any other ftmode, steps them "
                        "all, the unreached ones on zero gradients")
    return p


def _load_init_params(args, cfg: FinetuneConfig):
    """Initial parameters, or None (run_cavmae_ft_base.py:243-258): a
    ``.pth`` through ``import_cavmae_ft`` (non-strict), or a port pretrain
    params file through ``transfer_pretrain_to_ft``, each over a fresh
    model from seed 0."""
    path = args.pretrain_path
    if not path or path == "None":
        return None
    from avsiam_tpu_torch.models.cavmae_ft import CAVMAEFinetune
    fresh = CAVMAEFinetune(cfg.model, "cpu",
                           torch.Generator().manual_seed(0)).state_dict()
    if path.endswith(".pth"):
        from avsiam_tpu_torch.utils.torch_import import (import_cavmae_ft,
                                                         load_torch_checkpoint)
        sd, missing, unused = import_cavmae_ft(
            load_torch_checkpoint(path), fresh, depth=cfg.model.vit.depth)
        print(f"loaded {path}: {len(missing)} fresh-init params, "
              f"{len(unused)} unused torch keys")
        return sd
    from avsiam_tpu_torch.utils.checkpoint import (restore_params_from_path,
                                                   transfer_pretrain_to_ft)
    print(f"initialized finetune params from pretrain params {path}")
    return transfer_pretrain_to_ft(
        restore_params_from_path(path, map_location="cpu"), fresh)


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = platform_device()
    model_cfg = finetune_config(args.model, label_dim=args.n_class,
                                dtype=torch_dtype(args.dtype),
                                attn_impl=args.attn_impl,
                                mlp_impl=args.mlp_impl)
    model_cfg = replace(model_cfg, vit=replace(
        model_cfg.vit, audio_length=args.target_length))
    mesh = mesh_from_args(args, model_cfg)
    # the data axis must divide the global batch
    local_batch(args.batch_size, mesh.data)
    if is_main_process():
        dump_args(args, args.exp_dir)
    setup_wandb(args)
    mel, im_res = model_cfg.vit.mel_bins, model_cfg.vit.img_size
    nf = model_cfg.num_eval_frames
    cfg = FinetuneConfig(
        model=model_cfg,
        audio=audio_config_from_args(args, train=True, num_mel_bins=mel),
        opt=optimizer_from_args(args), batch_size=args.batch_size,
        n_epochs=args.n_epochs, head_lr=args.head_lr, mm_lr=args.mm_lr,
        freeze_base=bool(args.freeze_base), ftmode=args.ftmode,
        ftmode_test=args.ftmode_test, loss=args.loss, metrics=args.metrics,
        label_smooth=args.label_smooth,
        parity_optimizer=bool(args.parity_optimizer),
        n_print_steps=args.n_print_steps, seed=args.seed,
        exp_dir=args.exp_dir, save_model=bool(args.save_model),
        keep_train_states=args.keep_train_states,
        train_state_every=args.train_state_every)

    def dataset(path, train):
        return dataset_from_args(args, path, train=train,
                                 label_smooth=args.label_smooth,
                                 num_mel_bins=mel, im_res=im_res,
                                 num_frames=nf)

    train_ds = dataset(args.data_train, True)
    val_ds = dataset(args.data_val, False) if args.data_val else None
    weights = balance_weights_from_args(args, len(train_ds))
    out = run_finetune(cfg, train_ds, val_ds,
                       init_params=_load_init_params(args, cfg),
                       balance_weights=weights, wa=bool(args.wa),
                       wa_start=args.wa_start, wa_end=args.wa_end,
                       resume=args.resume,
                       max_steps_per_epoch=args.max_steps_per_epoch,
                       # read now: the rank-0 print mesh_from_args set up
                       log=print, device=device,
                       trace_dir=args.trace_dir)
    print("finetune done:", {k: out.get(k) for k in ("best_epoch", "best")})
    if args.data_eval and not out.get("diverged"):
        # the held-out set with the best checkpoint (the reference's
        # separate --data_eval split)
        from avsiam_tpu_torch.eval.metrics import mean_ap, mean_auc
        from avsiam_tpu_torch.train.loops import ft_eval_step_for, validate_ft
        from avsiam_tpu_torch.parallel.tp import load_full_state_dict
        from avsiam_tpu_torch.utils.checkpoint import restore_params
        model = out["model"]
        if os.path.exists(os.path.join(cfg.exp_dir, "models",
                                       "best_audio_model")):
            model = copy.deepcopy(model)  # the run's state stays the final
            load_full_state_dict(model, restore_params(
                cfg.exp_dir, "best_audio_model", map_location=device))
        else:
            # best_audio_model exists only where --data_val chose one
            print("no best checkpoint (no --data_val); evaluating final "
                  "params on --data_eval")
        # its own graphs on the card: the graphed eval forward is bound to
        # one model
        stats, loss, _ = validate_ft(ft_eval_step_for(cfg, device), model,
                                     dataset(args.data_eval, False), cfg,
                                     max_steps=args.max_steps_per_epoch,
                                     device=device)
        print(f"eval set: mAP {mean_ap(stats):.4f} AUC {mean_auc(stats):.4f} "
              f"acc {stats[0]['acc']:.4f} loss {loss:.4f}")
        out["eval_stats"] = stats
    return out


if __name__ == "__main__":
    main()
