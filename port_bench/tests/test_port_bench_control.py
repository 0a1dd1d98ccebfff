"""The control of each cell comes out not correct: the plain reference put
in the program's place one precision step below the configuration's
(TF32 for the tomography's fp32, fp8 for the model's bf16), judged by the
cell's own comparison and limits. On the CPU at sizes a test run holds;
marked ``card``, at the cell's own size on the card."""
from pathlib import Path

import pytest

from port_bench import bench
from port_bench.tests.helpers import SMALL, TINY_MODEL

# a model whose logits spread like the cell's, so that fp8's gap shows
SERVE_MODEL = {**TINY_MODEL, "num_layers": 4, "d_model": 512,
               "num_heads": 8, "num_kv_heads": 4, "head_dim": 64,
               "d_ff": 1024, "vocab_size": 8192}
SIZES = {
    "tomo-tem-256.stream": SMALL["tomo-tem-256.stream"],
    "internlm2-1.8b.train_1k": SMALL["internlm2-1.8b.train_1k"],
    "internlm2-1.8b.train_4k": SMALL["internlm2-1.8b.train_4k"],
    "internlm2-1.8b.serve_2k": {"config": {"model": SERVE_MODEL},
                                "traffic": {"prompt_len": 64, "gen": 8,
                                            "batch": 8}},
}


def control_fails(root: Path, workload: str, seed: int, device: str,
                  sizes: dict | None = None) -> tuple[bool, dict]:
    """(whether the control fails one of the cell's numbers, its
    readings)."""
    cell, config, traffic, settings = bench.cell_files(root, workload)
    if sizes:
        config = {**config, **sizes.get("config", {})}
        traffic = {**traffic, **sizes.get("traffic", {})}
    driver = bench.load_driver(root, traffic["driver"])
    readings = driver.control_readings(config, traffic, seed, device)
    limits = (sizes or {}).get("settings", settings)["limits"]
    failed = [k for k, v in readings.items() if k.split(".")[0] in limits
              and ".control" in k and v > limits[k.split(".")[0]]]
    return bool(failed), readings


@pytest.mark.parametrize("workload", sorted(SIZES))
@pytest.mark.parametrize("seed", [1, 3])
def test_port_bench_control_is_not_correct(root, workload, seed):
    failed, readings = control_fails(root, workload, seed, "cpu",
                                     SIZES[workload])
    assert failed, readings


@pytest.mark.card
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_port_bench_control_is_not_correct_at_the_cells_size(root, card,
                                                            workload):
    for seed in (101, 102, 103):
        failed, readings = control_fails(root, workload, seed, "cuda")
        assert failed, readings
