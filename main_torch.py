#!/usr/bin/env python
"""CLI driver of the PyTorch / CUDA port — the same flags as main.py
(cafe_tpu_torch/config.py), run by cafe_tpu_torch.train.loop.run.

Runs on the CUDA card; `--force_platform cpu` runs on the CPU instead
(the kernels' plain versions). Examples:
  python main_torch.py --force_platform cpu --dataset synthetic \\
      --synthetic_rows 4096 --synthetic_fields 4 --synthetic_vocab 2000 \\
      --embedding_dim 8 --mini_batch_size 128 --compress_method cafe \\
      --compress_rate 0.05 --print_freq 16 --test_freq 28
  python main_torch.py --dataset criteo --data_path /data/criteo \\
      --embedding_dim 16 --compress_method cafe --compress_rate 0.001 \\
      --cafe_sketch_threshold 500 --cafe_hash_rate 0.5 --learning_rate 0.1 \\
      --mini_batch_size 2048 --bf16 true --test_freq 30000
"""

from cafe_tpu_torch.config import parse_args
from cafe_tpu_torch.train.loop import run


def main(argv=None):
    """Parse `argv` (default sys.argv[1:]) and run; returns run's result."""
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
