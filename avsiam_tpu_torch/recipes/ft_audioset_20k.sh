#!/bin/bash
# AudioSet-20K finetune recipe (the north-star mAP benchmark), through the
# PyTorch port: the hyperparameters of recipes/ft_audioset_20k.sh.
# Parity: egs/audioset/run_base_ft.sh (lr 1e-4, head_lr x100, mm_lr x100,
# bs 4, 15 epochs, freqm 48, timem 192, mixup 0.5, label_smooth 0.1, BCE,
# metric mAP, noise True, bal none).
set -e
DATA_TRAIN=${DATA_TRAIN:-/data/audioset/train_20k.sqlite.db}
DATA_VAL=${DATA_VAL:-/data/audioset/eval.sqlite.db}
LABEL_CSV=${LABEL_CSV:-/data/audioset/class_labels_indices.csv}
PRETRAIN=${PRETRAIN:-None}
EXP_DIR=${EXP_DIR:-./exp/ft_as20k}

python -m avsiam_tpu_torch.cli.finetune \
  --model cav-mae-base \
  --dataset audioset \
  --data_train "$DATA_TRAIN" --data_val "$DATA_VAL" \
  --label_csv "$LABEL_CSV" --n_class 527 \
  --lr 1e-4 --head_lr 100 --mm_lr 100 \
  --n_epochs 15 --batch_size 4 \
  --lrscheduler_start 2 --lrscheduler_step 1 --lrscheduler_decay 0.5 \
  --freqm 48 --timem 192 --mixup 0.5 --label_smooth 0.1 \
  --loss BCE --metrics mAP \
  --dataset_mean -5.081 --dataset_std 4.4849 --target_length 1024 \
  --noise True --ftmode mm_grad \
  --pretrain_path "$PRETRAIN" \
  --mesh_data 1 \
  --exp_dir "$EXP_DIR" "$@"
# --mesh_data 1 matches the reference's single-GPU AS-20K recipe (global
# batch 4 doesn't divide larger meshes); to scale out, launch it under
# torchrun with e.g. 4 ranks and pass "--mesh_data 4 --batch_size 16".
# Flags in "$@" override earlier ones.
