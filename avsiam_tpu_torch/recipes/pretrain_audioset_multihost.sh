#!/bin/bash
# Multi-node AudioSet-2M pretraining through the PyTorch port: the
# reference's flagship deployment (egs/audioset/run_pretrain_base.sh:3-5,75:
# srun torchrun --nnodes=2 --nproc_per_node=8, 16 ranks over NCCL), with
# the hyperparameters of pretrain_audioset.sh.
#
# Run this same script on every node, with the rendezvous in the
# environment:
#   NNODES=2 NODE_RANK=<0|1> MASTER_ADDR=<node 0's host> MASTER_PORT=29400 \
#   NPROC_PER_NODE=8 bash avsiam_tpu_torch/recipes/pretrain_audioset_multihost.sh
# torchrun starts one rank a card and names the world (RANK, WORLD_SIZE,
# MASTER_ADDR, MASTER_PORT, LOCAL_RANK); the runner binds each rank to its
# card and makes an NCCL group (parallel/dist.py:initialize_multihost).
# --num_processes states the world this command line expects: the runner
# refuses a torchrun world of another size. Each rank feeds its block of
# the global batch, which must divide by the world (64 = 16 ranks x 4).
set -e
DATA_TRAIN=${DATA_TRAIN:-/data/audioset/train_2m.sqlite.db}
DATA_VAL=${DATA_VAL:-/data/audioset/eval.sqlite.db}
LABEL_CSV=${LABEL_CSV:-/data/audioset/class_labels_indices.csv}
EXP_DIR=${EXP_DIR:-./exp/pretrain_as2m_multihost}
NNODES=${NNODES:-1}
NODE_RANK=${NODE_RANK:-0}
NPROC_PER_NODE=${NPROC_PER_NODE:-8}
MASTER_ADDR=${MASTER_ADDR:-127.0.0.1}
MASTER_PORT=${MASTER_PORT:-29400}

exec torchrun --nnodes "$NNODES" --node_rank "$NODE_RANK" \
  --nproc_per_node "$NPROC_PER_NODE" \
  --master_addr "$MASTER_ADDR" --master_port "$MASTER_PORT" \
  -m avsiam_tpu_torch.cli.pretrain \
  --model cav-mae-base \
  --dataset audioset \
  --data-train "$DATA_TRAIN" --data-val "$DATA_VAL" \
  --label-csv "$LABEL_CSV" --n_class 527 \
  --lr 2e-4 --n-epochs 25 --batch-size 64 \
  --lrscheduler_start 10 --lrscheduler_step 5 --lrscheduler_decay 0.5 \
  --masking_ratio 0.25 --masking_ratio_a 0.25 --mask_mode unstructured \
  --contrast_loss_weight 1.0 --mae_loss_weight 0 \
  --dataset_mean -5.081 --dataset_std 4.4849 --target_length 1024 \
  --noise True --mixup 0.0 \
  --frame_source video \
  --num_processes "$((NNODES * NPROC_PER_NODE))" \
  --exp-dir "$EXP_DIR" "$@"
