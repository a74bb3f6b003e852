#!/bin/bash
# AudioSet-2M pretraining recipe on one NVIDIA card, through the PyTorch
# port: the hyperparameters of recipes/pretrain_audioset.sh, word for word.
# Parity: egs/audioset/run_pretrain_base.sh (2 nodes x 8 GPU, bs 4/GPU ->
# global 64, lr 2e-4, 25 epochs, MultiStepLR start 10 step 5 decay 0.5,
# mask 0.25, contrast=1 mae=0 (the loop runs both passes regardless),
# mean -5.081 std 4.4849, target_length 1024, noise aug on, mixup 0).
# One process drives the card; pretrain_audioset_multihost.sh runs the
# same command line under torchrun, one rank a card.
set -e
DATA_TRAIN=${DATA_TRAIN:-/data/audioset/train_2m.sqlite.db}
DATA_VAL=${DATA_VAL:-/data/audioset/eval.sqlite.db}
LABEL_CSV=${LABEL_CSV:-/data/audioset/class_labels_indices.csv}
EXP_DIR=${EXP_DIR:-./exp/pretrain_as2m}

python -m avsiam_tpu_torch.cli.pretrain \
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
  --exp-dir "$EXP_DIR" "$@"
