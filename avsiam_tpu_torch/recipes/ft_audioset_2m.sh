#!/bin/bash
# AudioSet-2M finetune recipe, through the PyTorch port: the
# hyperparameters of recipes/ft_audioset_2m.sh.
# Parity: egs/audioset/run_base_ft_2m.sh (lr 1e-5, balanced sampler, bs 64,
# 15 epochs, freqm 48, timem 192, mixup 0.5, BCE/mAP).
set -e
DATA_TRAIN=${DATA_TRAIN:-/data/audioset/train_2m.sqlite.db}
DATA_VAL=${DATA_VAL:-/data/audioset/eval.sqlite.db}
LABEL_CSV=${LABEL_CSV:-/data/audioset/class_labels_indices.csv}
WEIGHTS=${WEIGHTS:-/data/audioset/train_2m_weights.csv}
PRETRAIN=${PRETRAIN:-None}
EXP_DIR=${EXP_DIR:-./exp/ft_as2m}

python -m avsiam_tpu_torch.cli.finetune \
  --model cav-mae-base \
  --dataset audioset \
  --data_train "$DATA_TRAIN" --data_val "$DATA_VAL" \
  --label_csv "$LABEL_CSV" --n_class 527 \
  --lr 1e-5 --head_lr 100 --mm_lr 100 \
  --n_epochs 15 --batch_size 64 \
  --lrscheduler_start 2 --lrscheduler_step 1 --lrscheduler_decay 0.5 \
  --freqm 48 --timem 192 --mixup 0.5 --label_smooth 0.1 \
  --loss BCE --metrics mAP \
  --dataset_mean -5.081 --dataset_std 4.4849 --target_length 1024 \
  --noise True --ftmode mm_grad \
  --bal bal --weight_file "$WEIGHTS" \
  --pretrain_path "$PRETRAIN" \
  --exp_dir "$EXP_DIR" "$@"
