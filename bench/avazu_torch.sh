#!/bin/bash
# DLRM on Avazu — reference bench/avazu.sh: dim 16, lr 0.1, batch 128.
# The PyTorch / CUDA port's twin of bench/avazu.sh: the same flags,
# $1 and DATA, through main_torch.py on the card (add
# --force_platform cpu to $1 for the CPU). Exits with main_torch.py's code.

dlrm_extra_option=${1:-}
DATA=${DATA:-datasets/avazu}

python main_torch.py \
  --dataset avazu \
  --data_path "$DATA" \
  --embedding_dim 16 \
  --learning_rate 0.1 \
  --mini_batch_size 128 \
  --print_freq 1024 \
  --test_mini_batch_size 16384 \
  --tensor_board_filename board/avazu \
  $dlrm_extra_option 2>&1 | tee run_avazu_torch.log

rc=${PIPESTATUS[0]}
echo "done"
exit $rc
