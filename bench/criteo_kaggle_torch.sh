#!/bin/bash
# DLRM on Criteo Kaggle — canonical hyperparameters from the reference
# launcher (bench/criteo_kaggle.sh:19-31): dim 16, bot 13-512-256-64-16,
# top 512-256-1 (selected by --dataset criteo + --embedding_dim 16 in
# cafe_tpu_torch.train.loop.model_arch), lr 0.1, batch 128.
# Pass extra flags (e.g. --compress_method cafe --compress_rate 0.001) as $1.
# The PyTorch / CUDA port's twin of bench/criteo_kaggle.sh: the same flags,
# $1 and DATA, through main_torch.py on the card (add
# --force_platform cpu to $1 for the CPU). Exits with main_torch.py's code.

dlrm_extra_option=${1:-}
DATA=${DATA:-datasets/criteo}

python main_torch.py \
  --dataset criteo \
  --data_path "$DATA" \
  --embedding_dim 16 \
  --learning_rate 0.1 \
  --mini_batch_size 128 \
  --print_freq 1024 \
  --test_mini_batch_size 16384 \
  --tensor_board_filename board/criteo_kaggle \
  $dlrm_extra_option 2>&1 | tee run_kaggle_torch.log

rc=${PIPESTATUS[0]}
echo "done"
exit $rc
