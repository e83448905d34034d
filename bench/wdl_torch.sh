#!/bin/bash
# WDL on Criteo Terabyte — reference bench/wdl.sh: dim 128, lr 0.1,
# batch 2048, max-ind-range 40M, test every 102400 iterations.
# The PyTorch / CUDA port's twin of bench/wdl.sh: the same flags,
# $1 and DATA, through main_torch.py on the card (add
# --force_platform cpu to $1 for the CPU). Exits with main_torch.py's code.

dlrm_extra_option=${1:-}
DATA=${DATA:-datasets/criteotb}

python main_torch.py \
  --model wdl \
  --dataset criteotb \
  --data_path "$DATA" \
  --embedding_dim 128 \
  --max_ind_range 40000000 \
  --learning_rate 0.1 \
  --mini_batch_size 2048 \
  --print_freq 2048 \
  --test_freq 102400 \
  --test_mini_batch_size 16384 \
  --tensor_board_filename board/wdl_criteotb \
  $dlrm_extra_option 2>&1 | tee run_wdl_torch.log

rc=${PIPESTATUS[0]}
echo "done"
exit $rc
