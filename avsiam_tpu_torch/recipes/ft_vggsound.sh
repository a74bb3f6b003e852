#!/bin/bash
# VGGSound finetune recipe, through the PyTorch port: the hyperparameters
# of recipes/ft_vggsound.sh.
# Parity: egs/vggsound/run_base_ft.sh (lr 5e-5, head_lr x10, bs 64,
# 20 epochs, CE loss, metric acc, n_class 309).
set -e
DATA_TRAIN=${DATA_TRAIN:-/data/vggsound/train.sqlite.db}
DATA_VAL=${DATA_VAL:-/data/vggsound/test.sqlite.db}
LABEL_CSV=${LABEL_CSV:-/data/vggsound/class_labels_indices_vgg.csv}
PRETRAIN=${PRETRAIN:-None}
EXP_DIR=${EXP_DIR:-./exp/ft_vggsound}

python -m avsiam_tpu_torch.cli.finetune \
  --model cav-mae-base \
  --dataset vggsound \
  --data_train "$DATA_TRAIN" --data_val "$DATA_VAL" \
  --label_csv "$LABEL_CSV" --n_class 309 \
  --lr 5e-5 --head_lr 10 --mm_lr 10 \
  --n_epochs 20 --batch_size 64 \
  --lrscheduler_start 2 --lrscheduler_step 1 --lrscheduler_decay 0.5 \
  --freqm 48 --timem 192 --mixup 0.5 --label_smooth 0.1 \
  --loss CE --metrics acc \
  --dataset_mean -5.081 --dataset_std 4.4849 --target_length 1024 \
  --noise True --ftmode mm_grad \
  --pretrain_path "$PRETRAIN" \
  --exp_dir "$EXP_DIR" "$@"
