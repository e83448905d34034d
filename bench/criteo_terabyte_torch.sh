#!/bin/bash
# DLRM on Criteo Terabyte — canonical hyperparameters from the reference
# launcher (bench/criteo_terabyte.sh:19-34): dim 128, bot 13-512-256-128,
# top 1024-1024-512-256-1 (selected by --dataset criteotb), max-ind-range
# 40M, lr 1.0, batch 2048, test every 102400 iterations.
# The PyTorch / CUDA port's twin of bench/criteo_terabyte.sh: the same flags,
# $1 and DATA, through main_torch.py on the card (add
# --force_platform cpu to $1 for the CPU). Exits with main_torch.py's code.

dlrm_extra_option=${1:-}
DATA=${DATA:-datasets/criteotb}

python main_torch.py \
  --dataset criteotb \
  --data_path "$DATA" \
  --embedding_dim 128 \
  --max_ind_range 40000000 \
  --learning_rate 1.0 \
  --mini_batch_size 2048 \
  --print_freq 2048 \
  --test_freq 102400 \
  --test_mini_batch_size 16384 \
  --tensor_board_filename board/criteo_terabyte \
  $dlrm_extra_option 2>&1 | tee terabyte_torch.log

rc=${PIPESTATUS[0]}
echo "done"
exit $rc
