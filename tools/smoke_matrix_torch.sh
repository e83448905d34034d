#!/bin/bash
# CLI smoke matrix (flat) of the PyTorch / CUDA port: the same 15 cases
# as tools/smoke_matrix.sh (tiny-shape end-to-end drives of flag combos,
# each: name | extra flags), then the checkpoint-resume and
# raw-text->preprocess->train flows, through main_torch.py and
# cafe_tpu_torch.data.preprocess on the CPU (--force_platform cpu).
# Usage: bash tools/smoke_matrix_torch.sh   (exits non-zero on any failure)
cd "$(dirname "$0")/.."
BASE="--force_platform cpu --dataset synthetic --synthetic_rows 2048 --synthetic_fields 4 --synthetic_vocab 5000 --embedding_dim 8 --mini_batch_size 128 --nepochs 1 --print_freq 8 --test_freq 0"
declare -a CASES=(
  "ae_adam|--compress_method ae --compress_rate 0.05 --optimizer adam"
  "mde_adagrad|--compress_method mde --compress_rate 0.1 --optimizer adagrad"
  "qr_concat_adam|--compress_method qr --compress_rate 0.05 --qr_operation concat --optimizer adam"
  "qr_mult_bf16|--compress_method qr --compress_rate 0.05 --qr_operation mult --bf16 true"
  "cafe_plus_adam_k4|--compress_method cafe --compress_rate 0.05 --cafe_plus true --optimizer adam --steps_per_dispatch 4"
  "cafe_plus_inherit|--compress_method cafe --compress_rate 0.05 --cafe_plus true --cafe_plus_inherit true"
  "off_adam_bf16|--compress_method off --compress_rate 0.05 --optimizer adam --bf16 true"
  "hash_donate_k8|--compress_method hash --compress_rate 0.1 --donate_state true --steps_per_dispatch 8"
  "full_wdl|--model wdl"
  "dcn_adam_bf16|--model dcn --optimizer adam --bf16 true"
  "cafe_sep_field|--compress_method cafe --compress_rate 0.05 --cafe_hot_separate_field true"
  "ada_adam_d64|--compress_method ada --compress_rate 0.1 --embedding_dim 64 --optimizer adam"
  "lr_policy|--compress_method hash --compress_rate 0.1 --lr_num_warmup_steps 4 --lr_decay_start_step 8 --lr_num_decay_steps 8"
  "mod_range|--compress_method hash --compress_rate 0.1 --max_ind_range 1000"
  "throughput_quant|--compress_method cafe --compress_rate 0.05 --test_throughput true --test_freq 16"
)
FAILED=0
for case in "${CASES[@]}"; do
  name="${case%%|*}"; flags="${case#*|}"
  out=$(timeout 300 python main_torch.py $BASE $flags 2>&1)
  rc=$?
  if [ $rc -ne 0 ]; then
    FAILED=1
    echo "FAIL[$name] rc=$rc"
    echo "$out" | tail -8 | sed "s/^/    /"
  else
    echo "ok  [$name]"
  fi
done

# checkpoint save -> crash-recovery resume from the rolling slot
CKPT=$(mktemp -d)/m
out=$(timeout 300 python main_torch.py $BASE --compress_method cafe --compress_rate 0.05 --save_model $CKPT --save_freq 8 2>&1) \
  && out2=$(timeout 300 python main_torch.py $BASE --nepochs 2 --compress_method cafe --compress_rate 0.05 --load_model $CKPT 2>&1) \
  && echo "$out2" | grep -q "resuming from the rolling checkpoint" \
  && echo "ok  [ckpt_rolling_resume]" \
  || { FAILED=1; echo "FAIL[ckpt_rolling_resume]"; echo "$out2" | tail -6; }
# raw criteo text -> preprocess CLI -> train from the binary dir
E2E=$(mktemp -d)
python - "$E2E" << 'EOF'
import sys
import numpy as np
rng = np.random.default_rng(0)
with open(sys.argv[1] + "/train.txt", "w") as f:
    for _ in range(3000):
        label = str(rng.integers(0, 2))
        dense = [str(int(rng.integers(0, 9))) if rng.random() > 0.1 else ""
                 for _ in range(13)]
        cats = [format(int(rng.integers(0, 200)), "x")
                if rng.random() > 0.05 else "" for _ in range(26)]
        f.write("\t".join([label] + dense + cats) + "\n")
EOF
timeout 300 python -m cafe_tpu_torch.data.preprocess --dataset criteo \
    --input "$E2E/train.txt" --output "$E2E/bin" > /dev/null 2>&1 \
  && timeout 300 python main_torch.py --force_platform cpu --dataset criteo \
    --data_path "$E2E/bin" --embedding_dim 8 --mini_batch_size 128 \
    --nepochs 1 --print_freq 8 --test_freq 16 \
    --compress_method cafe --compress_rate 0.1 > /dev/null 2>&1 \
  && echo "ok  [raw_preprocess_train_e2e]" \
  || { FAILED=1; echo "FAIL[raw_preprocess_train_e2e]"; }

exit $FAILED
