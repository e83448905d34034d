#!/bin/bash
# Sharded CLI smoke matrix of the PyTorch / CUDA port: the 10 cases of
# tools/smoke_matrix_sharded.sh (an 8-device mesh, --shard_embeddings
# true), each through main_torch.py on 8 gloo ranks of the CPU, one
# process a rank, started as the tests start them
# (tests/torch_dist_worker.py: spawned processes, a file:// store).
# Usage: bash tools/smoke_matrix_sharded_torch.sh   (exits non-zero on any failure)
cd "$(dirname "$0")/.."
BASE="--force_platform cpu --dataset synthetic --synthetic_rows 2048 --synthetic_fields 4 --synthetic_vocab 40000 --embedding_dim 16 --mini_batch_size 128 --nepochs 1 --print_freq 8 --test_freq 0 --mesh_shape 8 --shard_embeddings true"
declare -a CASES=(
  "sh_cafe_plus_adam|--compress_method cafe --compress_rate 0.05 --cafe_plus true --optimizer adam"
  "sh_cafe_2level_uniq|--compress_method cafe --compress_rate 0.05 --mesh_inner 4 --shard_unique_frac 0.5"
  "sh_hash_adam_uniq_k4|--compress_method hash --compress_rate 0.1 --optimizer adam --shard_unique_frac 0.5 --steps_per_dispatch 4"
  "sh_qr_adagrad|--compress_method qr --compress_rate 0.05 --optimizer adagrad"
  "sh_off_2level|--compress_method off --compress_rate 0.05 --mesh_inner 2"
  "sh_ada_d64_adam|--compress_method ada --compress_rate 0.1 --embedding_dim 64 --optimizer adam"
  "sh_auto_mde|--compress_method mde --compress_rate 0.1 --shard_exchange auto"
  "sh_cafe_bf16_throughput|--compress_method cafe --compress_rate 0.05 --bf16 true --test_throughput true --test_freq 16"
  "sh_full_dcn_2level|--model dcn --mesh_inner 4"
  "sh_cafe_sep_field_adam|--compress_method cafe --compress_rate 0.05 --cafe_hot_separate_field true --optimizer adam"
)
FAILED=0
for case in "${CASES[@]}"; do
  name="${case%%|*}"; flags="${case#*|}"
  out=$(timeout 420 python tests/torch_dist_worker.py --world 8 -- $BASE $flags 2>&1)
  rc=$?
  if [ $rc -ne 0 ]; then
    FAILED=1
    echo "FAIL[$name] rc=$rc"
    echo "$out" | tail -10 | sed "s/^/    /"
  else
    echo "ok  [$name]"
  fi
done
exit $FAILED
