"""Sizes a CPU holds for each cell, and a run of a cell at them."""
from __future__ import annotations

import time
from pathlib import Path

TINY_MODEL = {"num_layers": 2, "d_model": 64, "num_heads": 4,
              "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
              "vocab_size": 256, "rope_theta": 10000.0, "dtype": "bfloat16",
              "param_dtype": "bfloat16", "remat": "full",
              "attention_impl": "flash", "attention_block_q": 16,
              "attention_block_kv": 32}

# at the tiny width bf16 rounds further from fp32 than at the cells' own:
# the training numbers' limits there, set from this size's readings as
# the cells' are from theirs (the program 7e-5-2e-4, 1.1e-3-1.3e-3,
# 8e-4-1.7e-3; the fp8 control 1.6e-3-3.6e-3, 0.018-0.021, 0.0075-0.010)
TINY_TRAIN_LIMITS = {"loss_gap": 6e-4, "grad_gap": 6e-3, "change_gap": 4e-3}

SMALL = {
    "tomo-tem-256.stream": {"config": {
        "nray": 16, "angles": 9, "nslice": 16, "batch_slices": 8,
        "partitions": 2, "executors": 2}},
    "internlm2-1.8b.train_1k": {
        "config": {"model": TINY_MODEL}, "traffic": {"seq": 48},
        "settings": {"limits": TINY_TRAIN_LIMITS}},
    "internlm2-1.8b.train_4k": {
        "config": {"model": TINY_MODEL}, "traffic": {"seq": 64},
        "settings": {"limits": TINY_TRAIN_LIMITS}},
    "internlm2-1.8b.serve_2k": {"config": {"model": TINY_MODEL},
                                "traffic": {"prompt_len": 40, "gen": 6,
                                            "clients": 8, "batch": 4,
                                            "sample_requests": 1000}},
}


def run_small(root: Path, workload: str, seed: int = 12345,
              seconds: float = 0.3, fault: str | None = None,
              overrides: dict | None = None) -> dict:
    from port_bench import bench

    ov = {k: dict(v) for k, v in SMALL[workload].items()}
    for k, v in (overrides or {}).items():
        ov.setdefault(k, {}).update(v)
    return bench.run_cell(root, workload, seed, seconds, False, "cpu",
                          time.perf_counter(), fault=fault, overrides=ov)
