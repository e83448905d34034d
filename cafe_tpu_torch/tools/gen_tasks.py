"""Generate the experiment task grids (tasks/*.json).

Operating points follow the published CAFE evaluation protocol
(ArtifactEvaluation/tasks/*.json): compress rates 0.5 -> 1e-4 with the
paired (sketch_threshold, hash_rate) schedule for CAFE, QR limited to
>= 2e-3, MDE/Ada to the rates they can support, plus the latency protocol
(train batch 2048 / test batch 16384 at cr 0.1) and sensitivity sweeps.
"""

from __future__ import annotations

import json
import os
import os.path as osp

CR_FULLRANGE = [0.5, 0.2, 0.1, 0.05, 0.02, 0.01, 0.005, 0.002, 0.001,
                0.0005, 0.0002, 0.0001]
CAFE_THRESHOLDS = [10, 10, 20, 30, 50, 100, 200, 500, 500, 500, 500, 500]
CAFE_HASH_RATES = [0.7, 0.5, 0.5, 0.5, 0.3, 0.3, 0.2, 0.2, 0.2, 0.1, 0.1, 0.1]

DATASETS = {
    "criteo": dict(embedding_dim=16, learning_rate=0.1, mini_batch_size=128,
                   print_freq=1024, test_freq=30000,
                   data_path="datasets/criteo"),
    "avazu": dict(embedding_dim=16, learning_rate=0.1, mini_batch_size=128,
                  print_freq=1024, test_freq=30000,
                  data_path="datasets/avazu"),
    "kdd12": dict(embedding_dim=64, learning_rate=0.1, mini_batch_size=128,
                  print_freq=1024, test_freq=30000,
                  data_path="datasets/kdd12"),
    "criteotb": dict(embedding_dim=128, learning_rate=1.0,
                     mini_batch_size=2048, print_freq=1024,
                     test_freq=102400, max_ind_range=40000000,
                     data_path="datasets/criteotb"),
}


def dataset_grid(name: str, base_extra=None) -> dict:
    base = {"dataset": name, **DATASETS[name]}
    if base_extra:
        base.update(base_extra)
    board = f"board/{name}"
    grid = {
        "base": base,
        "full": {"tensor_board_filename": f"{board}/full"},
        "hash": {"compress_method": "hash",
                 "tensor_board_filename": f"{board}/hash",
                 "compress_rate": CR_FULLRANGE},
        "qr": {"compress_method": "qr",
               "tensor_board_filename": f"{board}/qr",
               "compress_rate": [c for c in CR_FULLRANGE if c >= 0.002]},
        "ada": {"compress_method": "ada",
                "tensor_board_filename": f"{board}/ada",
                "compress_rate": [0.5, 0.2]},
        "mde": {"compress_method": "mde",
                "tensor_board_filename": f"{board}/mde",
                "compress_rate": [0.5, 0.2, 0.1]},
        "cafe": {"compress_method": "cafe",
                 "tensor_board_filename": f"{board}/cafe",
                 "compress_rate": CR_FULLRANGE,
                 "cafe_sketch_threshold": CAFE_THRESHOLDS,
                 "cafe_hash_rate": CAFE_HASH_RATES},
        "off": {"compress_method": "off",
                "tensor_board_filename": f"{board}/off",
                "compress_rate": [0.1, 0.01, 0.001, 0.0001],
                "cafe_hash_rate": [0.5, 0.3, 0.2, 0.1]},
    }
    return grid


def latency_grid() -> dict:
    base = {"dataset": "criteotb", **DATASETS["criteotb"],
            "test_throughput": True, "compress_rate": 0.1}
    out = {"base": base}
    for met in ["hash", "qr", "mde", "ada", "cafe"]:
        out[met] = {"compress_method": met,
                    "tensor_board_filename": f"board/latency/{met}"}
    return out


def sensitivity_grids() -> dict:
    """Hyperparameter sensitivity at criteo cr=0.001 (tasks/sensitivity/)."""
    base = {"dataset": "criteo", **DATASETS["criteo"],
            "compress_method": "cafe", "compress_rate": 0.001}
    return {
        "decay": {"base": base, "cafe": {
            "compress_method": "cafe",
            "tensor_board_filename": "board/sensitivity/decay",
            "cafe_decay": [0.9, 0.95, 0.98, 1.0]}},
        "hash_rate": {"base": base, "cafe": {
            "compress_method": "cafe",
            "tensor_board_filename": "board/sensitivity/hash_rate",
            "cafe_hash_rate": [0.6, 0.5, 0.3, 0.2, 0.1, 0.01, 0.001,
                               0.0001, 0.00001]}},
        "threshold": {"base": base, "cafe": {
            "compress_method": "cafe",
            "tensor_board_filename": "board/sensitivity/threshold",
            "cafe_sketch_threshold": [100, 300, 500, 700, 900]}},
        "use_freq": {"base": base, "cafe": {
            "compress_method": "cafe", "cafe_use_freq": True,
            "tensor_board_filename": "board/sensitivity/use_freq"}},
        "separate_field": {"base": base, "cafe": {
            "compress_method": "cafe", "cafe_hot_separate_field": True,
            "tensor_board_filename": "board/sensitivity/separate_field"}},
    }


def main(out_dir: str = "tasks"):
    os.makedirs(out_dir, exist_ok=True)
    for name in DATASETS:
        with open(osp.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(dataset_grid(name), f, indent=2)
    for model in ["wdl", "dcn"]:
        grid = dataset_grid("criteotb", {"model": model})
        for sec in grid.values():
            if "tensor_board_filename" in sec:
                sec["tensor_board_filename"] = sec[
                    "tensor_board_filename"].replace("board/",
                                                     f"board/{model}_")
        with open(osp.join(out_dir, f"{model}_criteotb.json"), "w") as f:
            json.dump(grid, f, indent=2)
    with open(osp.join(out_dir, "latency.json"), "w") as f:
        json.dump(latency_grid(), f, indent=2)
    os.makedirs(osp.join(out_dir, "sensitivity"), exist_ok=True)
    for name, grid in sensitivity_grids().items():
        with open(osp.join(out_dir, "sensitivity", f"{name}.json"),
                  "w") as f:
            json.dump(grid, f, indent=2)
    print(f"wrote task grids to {out_dir}/")


if __name__ == "__main__":
    main()
