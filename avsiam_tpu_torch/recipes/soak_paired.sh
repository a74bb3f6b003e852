#!/bin/bash
# The paired end-to-end check on the card, through the PyTorch port: the
# command lines of scripts/soak_paired.sh (soak leg 3) on the port's
# runners. Pretraining on 'synthetic_paired' clips (audio tone-bank
# amplitudes == frame band intensities, a latent per clip;
# data/dataset.py) carries learnable cross-modal structure, so the train
# loss_c must sink below ln(B), and the held-out eval loss_c and the
# retrieval R@K on the held-out gallery must follow: generalization, not
# memorization.
#
# Usage: EXP=<dir> EPOCHS=72 bash avsiam_tpu_torch/recipes/soak_paired.sh
# (the leg's settings, docs/artifacts/soak_r04/leg3_paired/args.json:
# 72 epochs of 8 steps, validation every 4). To continue a cut run, run it
# again with the same EXP and RESUME=--resume.
set -e
EXP=${EXP:-./exp/soak_paired}
N=${N:-256}           # train clips; B=32 -> 8 steps/epoch
NVAL=${NVAL:-64}      # held-out clips (eval + retrieval gallery)
B=${B:-32}
EPOCHS=${EPOCHS:-24}  # 192 steps
SEED=${SEED:-87}
mkdir -p "$EXP"

python - "$EXP" "$N" "$NVAL" <<'PY'
import json, sys
exp, n, nval = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
def idx(path, lo, hi):
    json.dump({"data": [{"wav": f"/paired/clip{i:06d}.wav",
                         "labels": f"/m/{i % 8}"} for i in range(lo, hi)]},
              open(path, "w"))
idx(f"{exp}/train.json", 0, n)
idx(f"{exp}/val.json", n, n + nval)      # held out
with open(f"{exp}/labels.csv", "w") as f:
    f.write("index,mid,display_name\n")
    for i in range(8):
        f.write(f"{i},/m/{i},c{i}\n")
PY

echo "== leg 3: $EPOCHS epochs x $((N / B)) steps, paired data =="
python -m avsiam_tpu_torch.cli.pretrain \
  --data-train "$EXP/train.json" --data-val "$EXP/val.json" \
  --label-csv "$EXP/labels.csv" --n_class 8 \
  --frame_source synthetic_paired --batch-size "$B" --lr 2e-4 \
  --lrscheduler_start 1000 \
  --n-print-steps 8 --n-epochs "$EPOCHS" --exp-dir "$EXP/exp" \
  --save_model False --train_state_every 48 --keep_train_states 1 \
  --val_interval 4 --frame_use 5 --seed "$SEED" $RESUME

echo "== retrieval on the HELD-OUT 64-clip gallery (best_audio_model) =="
python -m avsiam_tpu_torch.cli.retrieval \
  --data-eval "$EXP/val.json" --label-csv "$EXP/labels.csv" \
  --n_class 8 --frame_source synthetic_paired --batch-size "$B" \
  --pretrain_path "$EXP/exp/models/best_audio_model" \
  --exp-dir "$EXP/ret" --frame_use 5
echo "soak_paired OK: $EXP"
