"""A tiny configuration and traffic for the benchmark's CPU tests: the
real code paths (both table parts, promotions past the lossless cap) at
sizes a CPU runs in seconds."""

TINY_CONF = {
    "name": "tiny",
    "system": "dlrm_cafe",
    "reference": "dlrm_cafe",
    "config": {"dataset": "criteo", "model": "dlrm", "embedding_dim": 8,
               "compress_method": "cafe", "compress_rate": 0.05,
               "cafe_sketch_threshold": 8.0, "cafe_hash_rate": 0.5,
               "cafe_decay": 0.99, "optimizer": "sgd", "bf16": True,
               "cafe_insert_interval": 1, "learning_rate": 0.1,
               "mini_batch_size": 64},
    "counts": [3, 40, 300, 2000, 5000],
    "num_dense": 13,
    "ln_bot": [13, 512, 256, 64, 8],
    "ln_top": [23, 512, 256, 1],
}


def train_traffic(k=1, interval=1, batch=64):
    return {"generator": "criteo_stream", "entry": "train", "batch": batch,
            "steps_per_dispatch": k, "cafe_insert_interval": interval,
            "warm_hot_share": 0.9,
            "pool_examples_per_s": 2000.0, "warmup_dispatches": 1,
            "trace_dispatches": 2, "host_probe_dispatches": 2}


TRAIN_LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2}


def manifest(names):
    """A manifest for tiny training cells."""
    names = list(names)
    return {
        "workloads": [{"name": n, "config": "tiny", "traffic": n, "chips": 1}
                      for n in names],
        "end_to_end": [
            {"name": "train_examples_per_s", "unit": "examples/s"},
            {"name": "train_step_p95_ms", "unit": "ms"},
            {"name": "peak_mem_gib", "unit": "GiB"},
            {"name": "setup_s", "unit": "s"}],
        "per_layer": [
            {"name": "train_dispatch_host_ms", "unit": "ms"}],
    }
