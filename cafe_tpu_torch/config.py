"""Run configuration — a copy of cafe_tpu/config.py.

The port keeps its own copy so that it imports nothing of `cafe_tpu`; the
two stay field-for-field equal (tests/test_torch_imports.py checks). The
knob comments are the JAX package's and describe its TPU measurements.

Mirrors the reference CLI surface (ArtifactEvaluation/main.py:136-186) so task
grids written for the reference (tasks/*.json) drive this framework unchanged,
plus TPU-specific knobs (mesh shape, precision policy) that have no reference
equivalent.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class Config:
    # model
    model: str = "dlrm"  # dlrm | wdl | dcn
    # data
    data_path: str = ""
    dataset: str = "criteo"  # criteo | criteotb | avazu | kdd12 | criteotb13 | synthetic
    # model shape
    embedding_dim: int = 16
    max_ind_range: int = -1
    # legacy DLRM model options (dlrm_s_pytorch.py:369-374, 779-848)
    arch_interaction_op: str = "dot"        # dot | cat
    arch_interaction_itself: bool = False
    loss_threshold: float = 0.0             # clamp p to [t, 1-t] when 0<t<1
    weighted_pooling: str = ""              # "" | fixed | learned (v_W_l)
    # embedding compression
    compress_method: Optional[str] = None  # None|hash|mde|qr|ada|cafe|off|full|ae
    compress_rate: float = 0.001
    # mde
    md_round_dims: bool = False
    # qr (legacy tricks/qr_embedding_bag.py composition op)
    qr_operation: str = "add"               # add | mult | concat
    # cafe knobs (same semantics as reference --cafe_*)
    cafe_sketch_threshold: float = 500.0
    cafe_hash_rate: float = 0.5
    cafe_decay: float = 0.99
    cafe_hot_separate_field: bool = False
    cafe_use_freq: bool = False
    # CAFE+ (TOIS) two-tier sketch options
    cafe_plus: bool = False            # use two-tier staged sketch w/ adaptive threshold
    cafe_adjust_threshold: bool = True
    cafe_alpha: float = 1.000001       # lazy-decay growth per batch
    cafe_plus_inherit: bool = False    # staging evictions pass their count to
                                       # the newcomer (v1's Space-Saving rule;
                                       # OFF = reference CAFE+ semantics).
                                       # Rescues CAFE+ at extreme compression
                                       # (see docs/EXPERIMENTS.md)
    cafe_plus_staging_frac: float = 0.1  # staging tier's bucket share (the
                                       # reference hard-codes 0.1); raise to
                                       # ~0.3-0.5 at tight compression, or
                                       # -1 = flow-proportional auto
                                       # (sizing.auto_staging_frac)
    cafe_mig_lanes: int = 256          # migration-lane budget: per SHARD in the
                                       # sharded step; x16 (min 4096) on a single
                                       # device. Promotions beyond it are reverted
                                       # losslessly and retry on the next touch
    cafe_land_impl: str = "auto"       # insert landing reduction: auto (the
                                       # pallas flagged-scan kernel on TPU for
                                       # sketches <= 32k buckets — cafe step
                                       # 2.94 -> 2.31 ms on chip, bit-identical
                                       # state; segmax elsewhere) / segmax /
                                       # segsum1 / scan (ops/sorted_update.
                                       # land_max; A/B tools/ab_insert_land.py)
    cafe_insert_interval: int = 1      # feed grad-norm scores to the sketch every
                                       # k-th step (scores x k preserve expected
                                       # mass). 1 = reference-exact (insert after
                                       # every backward, main.py:376). The insert
                                       # is the costliest non-matmul op in the
                                       # fused step; k=8 amortizes it ~8x and is
                                       # AUC-neutral at cr >= ~1e-3, but costs
                                       # ~2 AUC pts at cr = 1e-4 (tiny hot sets
                                       # are promotion-timing sensitive) — A/B
                                       # table in docs/EXPERIMENTS.md. Keep 1
                                       # at extreme compression.
    # training
    mini_batch_size: int = 128
    test_mini_batch_size: int = 16384
    nepochs: int = 1
    learning_rate: float = 0.01
    optimizer: str = "sgd"  # sgd | adagrad | adam (rows-Adam on tables)
    # LR policy (legacy LRPolicyScheduler, dlrm_s_pytorch.py:171-208)
    lr_num_warmup_steps: int = 0
    lr_decay_start_step: int = 0
    lr_num_decay_steps: int = 0
    # inference-time row-wise embedding quantization (0 = off; 4 or 8)
    quantize_emb_bits: int = 0
    numpy_rand_seed: int = 123
    # eval cadence
    inference_only: bool = False
    test_freq: int = -1
    print_freq: int = 1
    test_throughput: bool = False
    # io
    save_model: str = ""
    load_model: str = ""
    save_freq: int = 0                 # ALSO save a rolling "<save_model>.latest"
                                       # every N iterations (preemption safety;
                                       # the reference only saves on best
                                       # accuracy, main.py:449-462)
    tensor_board_filename: str = "run_tpu"
    # synthetic dataset knobs (test backbone; reference analogue is the dead
    # RandomDataset path, dlrm_data_pytorch.py:759-872)
    synthetic_rows: int = 65536
    synthetic_fields: int = 8
    synthetic_vocab: int = 100000
    synthetic_dense: int = 13
    synthetic_zipf: float = 1.05
    # id distribution: zipf | uniform | gaussian | trace (stack-distance LRU
    # model, the reference's generate_synthetic_input_batch design)
    synthetic_dist: str = "zipf"
    synthetic_trace_file: str = ""     # id trace (.npy/.bin int32) for "trace"
    synthetic_shift: float = 0.0       # hot-set shift point in (0,1); 0 = off
    synthetic_vocab_spread: float = 1.0  # smallest/largest field-vocab ratio;
                                       # <1 gives log-spaced per-field vocabs
    # TPU-specific
    steps_per_dispatch: int = 1        # fuse K train steps into one jitted
                                       # call (amortizes host dispatch; print/
                                       # test cadence rounds to multiples of K)
    donate_state: bool = True          # donate TrainState buffers to the jitted
                                       # step (in-place table updates; the old
                                       # state is invalid after each step).
                                       # Neutral at VMEM-class dim-16 tables
                                       # (docs/PERF.md A/B) but REQUIRED at
                                       # HBM-class shapes: un-donated, XLA
                                       # copies the whole table per step —
                                       # 10.17 vs 4.84 ms/apply at CriteoTB
                                       # dim 128 (r5 ab_apply128)
    mesh_shape: Optional[int] = None   # number of devices for the data axis; None = all
    mesh_inner: int = 0                # >0: two-level ("dcn","ici") mesh with this
                                       # many ICI-adjacent chips per inner group;
                                       # the exchange combines within "ici" before
                                       # crossing "dcn" (hierarchical dedup)
    shard_embeddings: bool = False     # row-shard tables + sketch over the mesh
    shard_exchange: str = "explicit"   # explicit: shard_map dedup+AG/psum-scatter
                                       #   exchange with SHARD-LOCAL sketch
                                       #   (O(batch) traffic, HLO-verified)
                                       # a2a: request-routed all-to-all row legs
                                       #   (~n-fold fewer wire bytes; flat 1-D
                                       #   mesh; skew falls back to explicit)
                                       # pallas: a2a via direct remote DMAs
                                       #   (ops/pallas_a2a.py; identity-ordered
                                       #   1-D mesh only)
                                       # auto: XLA SPMD partitioner derives the
                                       #   collectives (always bit-equal to the
                                       #   single-device step)
    shard_unique_frac: float = 0.0     # >0: capacity-bounded unique-compact
                                       # exchange — ship ceil(frac*batch) deduped
                                       # ids/rows instead of full-batch buffers,
                                       # with a full-size fallback step whenever
                                       # any device sees more uniques (Zipf
                                       # streams: uniques are 2-5x fewer)
    bf16: bool = False                 # bfloat16 matmuls in the dense towers
    sparse_apply_impl: str = "auto"    # sgd sparse apply: auto (pallas RMW
                                       # kernel for HBM-class tables on TPU,
                                       # XLA scatter otherwise) / scatter /
                                       # pallas / dense (MXU row-sum kernel,
                                       # VMEM-class tables; loses in-step
                                       # unless updates arrive pre-sorted —
                                       # see ops/sparse._use_dense_rowsum)
    # multi-host (pod) execution: every process runs the same program;
    # jax.distributed stitches their local chips into one global mesh and
    # each process feeds its slice of every batch (SURVEY.md §2.6 — the
    # reference has no distributed execution; new design)
    dist_num_processes: int = 1
    dist_process_id: int = 0
    dist_coordinator: str = ""         # host:port of process 0
    force_platform: str = ""           # debug/tests: "cpu" forces the CPU
                                       # backend (the TPU plugin ignores
                                       # JAX_PLATFORMS env)
    # profiling (reference --enable-profiling, dlrm_s_pytorch.py:1576-1777)
    enable_profiling: bool = False
    profile_steps: int = 20
    # misc
    num_workers: int = 0               # unused; kept for reference-flag compat
    test_num_workers: int = 0
    use_gpu: bool = True               # unused; kept for reference-flag compat
    print_time: bool = True
    print_wall_time: bool = False
    print_precision: int = 5

    @property
    def method(self) -> str:
        m = self.compress_method
        return "full" if m in (None, "None", "none", "") else m


def _str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a CTR model on TPU.")
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        default = f.default
        if f.type in ("bool", bool) or isinstance(default, bool):
            p.add_argument(name, type=_str2bool, default=default)
        elif f.name == "compress_method":
            p.add_argument(name, type=str, default=None,
                           choices=[None, "hash", "mde", "qr", "ada", "cafe",
                                    "off", "full", "ae"])
        elif f.name == "mesh_shape":
            p.add_argument(name, type=int, default=None)
        elif isinstance(default, int):
            p.add_argument(name, type=int, default=default)
        elif isinstance(default, float):
            p.add_argument(name, type=float, default=default)
        else:
            p.add_argument(name, type=str, default=default)
    return p


def parse_args(argv=None) -> Config:
    ns = build_parser().parse_args(argv)
    return Config(**vars(ns))


def from_json(path: str) -> Config:
    """Load a config from a task-style JSON dict (flat key->value)."""
    with open(path) as f:
        d = json.load(f)
    valid = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in d.items() if k in valid})
