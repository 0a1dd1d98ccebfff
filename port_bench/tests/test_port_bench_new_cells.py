"""The cells ``mellum2-12b-a2.5b.serve_8k`` and ``internlm2-1.8b.train_dp4``
at sizes a CPU holds, through the harness's overrides: each unbroken run
correct, each run with its timed path broken underneath not (a served
token altered; a step whose update is never applied; the exchange between
the ranks left out), the controls and faults that each cell's limits are
set against, and the readers of their per-layer metrics on records built
by hand."""
import time

import pytest

from port_bench import bench, spanlog
from port_bench.tests.helpers import TINY_MODEL, TINY_TRAIN_LIMITS

MELLUM = "mellum2-12b-a2.5b.serve_8k"
DP4 = "internlm2-1.8b.train_dp4"
SLIDING, FULL = "sliding_attention", "full_attention"

SMALL = {
    MELLUM: {
        "config": {
            "hidden_size": 64, "num_attention_heads": 4,
            "num_key_value_heads": 2, "head_dim": 16,
            "num_hidden_layers": 4, "moe_intermediate_size": 32,
            "num_experts": 16, "num_experts_per_tok": 8, "vocab_size": 256,
            "layer_types": [SLIDING] * 3 + [FULL], "sliding_window": 8,
            "rope_parameters": {
                FULL: {"rope_type": "yarn", "rope_theta": 500000,
                       "factor": 4, "original_max_position_embeddings": 64,
                       "beta_fast": 32, "beta_slow": 1,
                       "attention_factor": 1.1386},
                SLIDING: {"rope_type": "default", "rope_theta": 500000}},
            "model": {"num_layers": 4, "d_model": 64, "num_heads": 4,
                      "num_kv_heads": 2, "head_dim": 16, "d_ff": 32,
                      "vocab_size": 256, "num_experts": 16,
                      "experts_per_token": 8, "moe_dropless": True,
                      "rope_theta": 500000.0, "dtype": "bfloat16",
                      "param_dtype": "bfloat16", "attention_impl": "flash",
                      "attention_block_q": 16, "attention_block_kv": 16}},
        "traffic": {"prompt_len": 24, "gen": 4, "clients": 8, "batch": 4,
                    "sample_requests": 1000}},
    DP4: {"config": {"model": TINY_MODEL},
          "traffic": {"seq": 48, "deadline_s": 300},
          "settings": {"limits": TINY_TRAIN_LIMITS}},
}


def run_small(root, workload, fault=None):
    return bench.run_cell(root, workload, 2147483647 + 77, 0.3, False, "cpu",
                          time.perf_counter(), fault=fault,
                          overrides=SMALL[workload])


@pytest.mark.parametrize("workload, fault", [
    (MELLUM, None), (MELLUM, "token_altered"),
    (DP4, None), (DP4, "state_unchanged"), (DP4, "no_exchange")])
def test_port_bench_new_cell_is_correct_only_unbroken(root, workload, fault):
    result = run_small(root, workload, fault)
    assert result["correct"] is (fault is None), result["checks"]
    assert result["attempted"] >= 1
    assert set(result["metrics"]) >= {"setup_s"}
    assert len(result["metrics"]) >= 2, result["metrics"]
    if workload == DP4:                 # all four ranks' tokens, one result
        assert result["device"]["count"] == 4
        assert result["metrics"]["train_tokens_per_s"]["value"] > 0


def mellum_readings(root, seed):
    cell, config, traffic, settings = bench.cell_files(root, MELLUM)
    config = {**config, **SMALL[MELLUM]["config"]}
    traffic = {**traffic, **SMALL[MELLUM]["traffic"]}
    driver = bench.load_driver(root, traffic["driver"])
    return driver.control_readings(config, traffic, seed, "cpu"), \
        settings["limits"]


@pytest.mark.parametrize("seed", [1, 3])
def test_port_bench_mellum_control_and_fault_are_not_correct(root, seed):
    """At CPU size and the cell's limits: the program inside each limit,
    fp8 outside one of them, and the altered token outside
    ``served_gap``'s."""
    readings, limits = mellum_readings(root, seed)
    assert all(readings[f"{k}.program"] <= v for k, v in limits.items()), \
        readings
    assert any(readings[f"{k}.control_fp8"] > v
               for k, v in limits.items()), readings
    assert readings["served_gap.fault_token_altered"] > \
        limits["served_gap"], readings


def dp4_readings(root, ranks, seed=5):
    cell, config, traffic, settings = bench.cell_files(root, DP4)
    config = {**config, **SMALL[DP4]["config"]}
    traffic = {**traffic, **SMALL[DP4]["traffic"], "ranks": ranks}
    driver = bench.load_driver(root, traffic["driver"])
    return driver.control_readings(config, traffic, seed, "cpu")


def test_port_bench_dp4_control_and_faults_are_not_correct(root):
    """fp8 and each fault, read by the cell's own comparison at CPU size,
    fail one of the numbers."""
    readings = dp4_readings(root, 4)
    for name in ("control_fp8", "fault_half_batch", "fault_no_exchange"):
        assert any(readings[f"{k}.{name}"] > v
                   for k, v in TINY_TRAIN_LIMITS.items()), (name, readings)


def test_port_bench_dp4_no_exchange_on_one_rank_is_the_reference(root):
    """On one rank the local chunk is the whole exchange: the reference's
    fault reads as the reference itself."""
    readings = dp4_readings(root, 1)
    for k in TINY_TRAIN_LIMITS:
        assert readings[f"{k}.fault_no_exchange"] < 1e-6, readings


def reader(root, name):
    return bench.load_module(bench.reader_path(root, name),
                             f"test_new_metric_{name.replace('.', '_')}")


def span(name, start, end, device_s, thread=1, **attrs):
    return {"name": name, "start": start, "end": end, "device_s": device_s,
            "thread": thread, "attrs": attrs}


# one traced batch: a prefill of 16 x 8 tokens and a decode step, each
# with a sliding and a full attention span and the MoE's four spans
MELLUM_LOG = [
    {"traced": False, "spans": [span("prefill", 0, 1, None)]},
    {"traced": True, "spans": [
        span("prefill", 0.0, 1.0, None),
        span("attention", 0.1, 0.2, 0.030, kind="sliding"),
        span("attention", 0.3, 0.4, 0.010, kind="full"),
        span("moe_route", 0.4, 0.5, 0.002), span("moe_dispatch", 0.5, 0.6,
                                                 0.003),
        span("moe_experts", 0.6, 0.7, 0.020, rows=256),
        span("moe_combine", 0.7, 0.8, 0.005),
        span("decode", 1.0, 1.1, None),
        span("attention", 1.01, 1.02, 0.001, kind="sliding"),
        span("moe_experts", 1.03, 1.04, 0.004, rows=32)]}]
MELLUM_REC = {"trace": {"units": 1, "window_s": 0.5}, "batch": 16,
              "prompt_len": 8, "gen": 2,
              "model": {"d_model": 2304, "d_ff": 896,
                        "experts_per_token": 8, "num_layers": 28}}


def test_port_bench_mellum_readers(root, monkeypatch):
    monkeypatch.setattr(spanlog, "batches", lambda: MELLUM_LOG)
    assert reader(root, "moe_share.mellum").read(MELLUM_REC) == \
        pytest.approx(100 * 0.034 / 0.5)
    # 16 x 8 prefill and 16 x 1 decoded tokens, 8 slots each in 28 layers
    flops = 6.0 * 2304 * 896 * 8 * 28 * (16 * 8 + 16)
    assert reader(root, "experts_roofline.mellum").read(MELLUM_REC) == \
        pytest.approx(100 * flops / 989e12 / 0.024)
    # the sliding span inside the prefill only
    assert reader(root, "window_attention_ms.mellum").read(MELLUM_REC) == \
        pytest.approx(30.0)


@pytest.mark.parametrize("log", [
    [],                                            # no span log
    [{"traced": True, "spans": [span("prefill", 0, 1, None)]}],  # parent
    [{"traced": True, "spans": [span("prefill", 0, 1, None),
                                span("moe_experts", 0.1, 0.2, None),
                                span("attention", 0.1, 0.2, None,
                                     kind="sliding")]}],  # the CPU
])
def test_port_bench_mellum_readers_find_nothing(root, monkeypatch, log):
    monkeypatch.setattr(spanlog, "batches", lambda: log)
    for name in ("moe_share.mellum", "experts_roofline.mellum",
                 "window_attention_ms.mellum"):
        assert reader(root, name).read(MELLUM_REC) is None, name


def test_port_bench_collective_ms_reads_the_window_steps(root):
    step = [span("dp_reduce_scatter", 0, 1, 0.040),
            span("dp_all_gather", 1, 2, 0.010)]
    rec = {"window_units": 2, "spans": [
        {"traced": False, "spans": [span("dp_reduce_scatter", 0, 1, 0.9)]},
        {"traced": False, "spans": step}, {"traced": False, "spans": step},
        {"traced": True, "spans": [span("dp_all_gather", 0, 1, 0.5)]}]}
    read = reader(root, "collective_ms.dp4").read
    assert read(rec) == pytest.approx(50.0)
    assert read({"window_units": 2, "spans": [
        {"traced": False, "spans": []}] * 2}) is None       # the parent
    assert read({"window_units": 2, "spans": [
        {"traced": False, "spans": [span("dp_all_gather", 0, 1, None)]}]
        * 2}) is None                                       # the CPU
