#!/bin/bash
# DLRM on KDD12 — reference bench/kdd12.sh:17-19: dim 64
# (bot 13-512-256-64-64 via model_arch), lr 0.1, batch 128.
# The PyTorch / CUDA port's twin of bench/kdd12.sh: the same flags,
# $1 and DATA, through main_torch.py on the card (add
# --force_platform cpu to $1 for the CPU). Exits with main_torch.py's code.

dlrm_extra_option=${1:-}
DATA=${DATA:-datasets/kdd12}

python main_torch.py \
  --dataset kdd12 \
  --data_path "$DATA" \
  --embedding_dim 64 \
  --learning_rate 0.1 \
  --mini_batch_size 128 \
  --print_freq 1024 \
  --test_mini_batch_size 16384 \
  --tensor_board_filename board/kdd12 \
  $dlrm_extra_option 2>&1 | tee run_kdd12_torch.log

rc=${PIPESTATUS[0]}
echo "done"
exit $rc
