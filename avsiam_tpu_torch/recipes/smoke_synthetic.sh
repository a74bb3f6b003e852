#!/bin/bash
# End-to-end smoke of the PyTorch port: pretrain -> finetune (from the
# pretrain checkpoint) -> retrieval, on synthetic data with the tiny model;
# the command lines of recipes/smoke_synthetic.sh. It runs on the card;
# on a host without one, set AVSIAM_PLATFORM=cpu (the plain PyTorch
# versions of the kernels). A few minutes.
set -e
WORK=${WORK:-$(mktemp -d)}
MODEL=${MODEL:-tiny}
cd "$WORK"

python - <<'PY'
import json
json.dump({"data": [{"wav": f"/s/{i}.wav", "labels": "/m/0" if i % 2 else "/m/1"}
                    for i in range(8)]}, open("idx.json", "w"))
open("labels.csv", "w").write(
    "index,mid,display_name\n0,/m/0,a\n1,/m/1,b\n2,/m/2,c\n")
PY

COMMON=(--label-csv labels.csv --n_class 3 --model "$MODEL" --batch-size 4
        --frame_source synthetic --target_length 128 --dtype float32
        --max_steps_per_epoch 2)

echo "== pretrain =="
python -m avsiam_tpu_torch.cli.pretrain --data-train idx.json --data-val idx.json \
  "${COMMON[@]}" --n-epochs 1 --exp-dir pre

echo "== finetune from pretrain checkpoint =="
python -m avsiam_tpu_torch.cli.finetune --data_train idx.json --data_val idx.json \
  --label_csv labels.csv --n_class 3 --model "$MODEL" --batch_size 4 \
  --frame_source synthetic --target_length 128 --dtype float32 \
  --max_steps_per_epoch 2 --n_epochs 1 \
  --pretrain_path "pre/models/audio_model.1" --exp_dir ft

echo "== retrieval =="
python -m avsiam_tpu_torch.cli.retrieval --data-eval idx.json \
  "${COMMON[@]:0:14}" --exp-dir ret

echo "smoke OK: $WORK"
