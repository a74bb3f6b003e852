"""Standalone retrieval evaluation of the port. Parity surface:
src/retrieval.py, through ``avsiam_tpu/cli/retrieval.py``, whose flags it
takes.

Extracts per-modality embeddings with the finetune model's 'retrieval' mode
(audio tokens and frame ``--frame_use``'s video tokens, cav_mae_base.py:
920), mean-pools them, and reports R@1/R@5/R@10/MedianR in both
directions; writes ``retrieval_result.csv`` (retrieval.py:127-149). One
process, as the JAX runner:

  python -m avsiam_tpu_torch.cli.retrieval --data-val idx.json \
      --pretrain_path <params file or .pth> --batch-size 64 \
      --exp-dir ./exp/retrieval

on the card (the default), or on the CPU with ``AVSIAM_PLATFORM=cpu``.
``--pretrain_path`` names a reference-format ``.pth`` (through
``import_cavmae_ft``), a params file a pretrain run of the port saved (its
trunk carried over, ``transfer_pretrain_to_ft``) or one a finetune run
saved (loaded as it is).
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from avsiam_tpu_torch.cli.common import (add_common_args,
                                         audio_config_from_args,
                                         dataset_from_args, platform_device,
                                         torch_dtype)
from avsiam_tpu_torch.configs import replace
from avsiam_tpu_torch.data.dataset import make_eval_transform
from avsiam_tpu_torch.data.samplers import batched, eval_shard_indices
from avsiam_tpu_torch.eval.retrieval import retrieval_metrics
from avsiam_tpu_torch.models.cavmae_ft import CAVMAEFinetune
from avsiam_tpu_torch.models.variants import finetune_config
from avsiam_tpu_torch.train import graphs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("avsiam-tpu-torch retrieval")
    add_common_args(p, ft=False)
    p.add_argument("--pretrain_path", type=str, default="None")
    p.add_argument("--directions", type=str, default="audio,video")
    p.add_argument("--frame_use", type=int, default=5)
    return p


def retrieval_features(model: CAVMAEFinetune, fb, img):
    """The 'retrieval' forward and each modality's mean over its tokens:
    (audio [B, C], video [B, C])."""
    with torch.no_grad():
        a_tok, v_tok = model(fb, img, "retrieval")
        return a_tok.mean(dim=1), v_tok.mean(dim=1)


def extract_features(args, model: CAVMAEFinetune, ds, max_batches=None):
    """(audio [N, C], video [N, C]) float32 numpy: the set's clips in order,
    in batches of ``args.batch_size`` assembled on the host from one
    ``RandomState(0)`` stream, the eval transform on the model's device,
    then ``retrieval_features``: on the card as CUDA graphs (the
    counterpart of the JAX runner's jitted ``feat``; the first batch runs
    eagerly as the warm-up, and a partial last batch gets a graph of its
    own), on the CPU eagerly."""
    device = next(model.parameters()).device
    forward = (graphs.GraphedForward(retrieval_features,
                                     "the retrieval forward")
               if graphs.available(device) else retrieval_features)
    cfg = model.cfg
    transform = make_eval_transform(
        audio_config_from_args(args, train=False,
                               num_mel_bins=cfg.vit.mel_bins),
        im_res=cfg.vit.img_size)
    a_all, v_all = [], []
    idx_batches = batched(eval_shard_indices(len(ds)), args.batch_size,
                          drop_last=False)
    rng = np.random.RandomState(0)
    for bi, idx in enumerate(idx_batches):
        if max_batches and bi >= max_batches:
            break
        host = ds.batch(idx, rng, frames_per_sample=1)
        fb, img, _ = transform(*(torch.from_numpy(np.ascontiguousarray(x))
                                 .to(device) for x in host))
        fa, fv = forward(model, fb, img)
        a_all.append(fa.float().cpu().numpy())
        v_all.append(fv.float().cpu().numpy())
    return np.concatenate(a_all), np.concatenate(v_all)


def load_params(path: str, model: CAVMAEFinetune):
    """Load ``--pretrain_path`` into ``model``: a ``.pth`` through
    ``import_cavmae_ft``; a port params file whose names hold the pretrain
    model's (``ast``, ``decoder``) through ``transfer_pretrain_to_ft``;
    else a finetune params file, as it is."""
    fresh = model.state_dict()
    if path.endswith(".pth"):
        from avsiam_tpu_torch.utils.torch_import import (import_cavmae_ft,
                                                         load_torch_checkpoint)
        sd, missing, unused = import_cavmae_ft(
            load_torch_checkpoint(path), fresh, depth=model.cfg.vit.depth)
        print(f"loaded {path}: {len(missing)} fresh-init params, "
              f"{len(unused)} unused torch keys")
    else:
        from avsiam_tpu_torch.utils.checkpoint import (
            restore_params_from_path, transfer_pretrain_to_ft)
        sd = restore_params_from_path(path, map_location="cpu")
        if any(k.startswith(("ast.", "decoder.")) for k in sd):
            sd = transfer_pretrain_to_ft(sd, fresh)
    model.load_state_dict(sd)


def model_config(args):
    """The finetune model's configuration of the flags: the preset
    ``--model``, its audio length ``--target_length``."""
    cfg = finetune_config(args.model, label_dim=args.n_class,
                          dtype=torch_dtype(args.dtype),
                          attn_impl=args.attn_impl, mlp_impl=args.mlp_impl)
    return replace(cfg, vit=replace(cfg.vit, audio_length=args.target_length))


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = platform_device()
    model_cfg = model_config(args)
    # loader-side frame selection (the reference's val_audio_conf
    # frame_use, retrieval.py:100-103): one frame decoded and encoded a clip
    ds = dataset_from_args(args, args.data_eval or args.data_val, train=False,
                           num_mel_bins=model_cfg.vit.mel_bins,
                           im_res=model_cfg.vit.img_size,
                           frame_use=args.frame_use)
    model = CAVMAEFinetune(model_cfg, device,
                           torch.Generator(device=device).manual_seed(0))
    if args.pretrain_path and args.pretrain_path != "None":
        load_params(args.pretrain_path, model)
    fa, fv = extract_features(args, model, ds)
    rows = []
    for direction in args.directions.split(","):
        m = retrieval_metrics(fa, fv, direction)
        print(f"{direction}: R@1 {m['R1']:.4f} R@5 {m['R5']:.4f} "
              f"R@10 {m['R10']:.4f} MR {m['MR']:.1f}")
        rows.append({"direction": direction, **m})
    os.makedirs(args.exp_dir, exist_ok=True)
    with open(os.path.join(args.exp_dir, "retrieval_result.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    return rows


if __name__ == "__main__":
    main()
