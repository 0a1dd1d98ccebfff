"""Every metric ``BENCHMARK.json`` names has a reader of its own, which
reads a record by hand-worked values and returns nothing where the record
holds nothing to read: never 0 for a share of a roofline or a peak."""
import pytest

from port_bench import bench
from port_bench import yardstick as ys

M = {"num_layers": 24, "d_model": 2048, "num_heads": 16, "num_kv_heads": 8,
     "head_dim": 128, "d_ff": 8192, "vocab_size": 92544}
TRACE = {"busy_s": 0.8, "window_s": 1.0, "units": 4,
         "labels": {"art": 0.8, "attention": 0.3, "adamw": 0.2,
                    "flash_attention": 0.04},
         "launches": {"flash_attention": 54},
         "calls": {"flash_attention": 24}}
RECORD = {"setup_s": 17.0, "window_s": 20.0, "window_units": 80,
          "slices": 4800,
          "spans": [{"total_s": 0.25, "stages": {"pump": 0.001,
                                                 "batch_fn": 0.2,
                                                 "sinks": 0.04}}] * 2,
          "art_nnz": 10_529_656, "nrow": 19_456, "ncol": 65_536,
          "sweeps": 2, "partition_slices": 16, "partitions": 4,
          "train_tokens": 163_840, "steps": 40, "batch": 4, "seq": 1024,
          "model": M, "ttft_s": [1.0] * 19 + [2.0], "served_tokens": 5120,
          "prefill_s": [0.3] * 20, "prompt_len": 2048,
          "decode_s": [0.7] * 20, "decode_steps": 300, "trace": TRACE}


def reader(root, name):
    return bench.load_module(bench.reader_path(root, name),
                             f"test_metric_{name.replace('.', '_')}")


def all_metrics(root):
    spec = bench.load_spec(root)
    return spec["end_to_end"] + spec["per_layer"]


def test_port_bench_every_metric_has_a_reader(root):
    for m in all_metrics(root):
        assert bench.reader_path(root, m["name"]).is_file(), m["name"]


def test_port_bench_a_split_metric_reads_with_its_stem(root):
    metrics = root / "port_bench" / "metrics"
    assert bench.reader_path(root, "idle_share.tomo") == \
        metrics / "idle_share.py"
    assert bench.reader_path(root, "sinks_share.tomo") == \
        metrics / "sinks_share.tomo.py"
    with pytest.raises(bench.BenchError):
        bench.reader_path(root, "no_such_metric.tomo")


def test_port_bench_readers_find_nothing_in_an_empty_record(root):
    for m in all_metrics(root):
        assert reader(root, m["name"]).read({"trace": {}}) is None, m["name"]


@pytest.mark.parametrize("name, want", [
    ("setup_s", 17.0),
    ("slices_per_s", 240.0),
    ("train_tokens_per_s", 8192.0),
    ("serve_tokens_per_s", 256.0),
    ("ttft_p95_s", 1.05),
    ("sinks_share.tomo", 0.4),
    ("stream_host_share.tomo", 100 * 2 * (0.25 + 0.001 - 0.24) / 20.0),
    # a unit's 0.2 s busy (0.8 s over 4 traced units) against its 0.25 s
    # of the untraced window (20 s over 80 units)
    ("idle_share.tomo", 20.0),
    ("idle_share.train", 20.0),
    ("idle_share.serve", 20.0),
    ("adamw_ms.train", 50.0),
    ("attention_share.train", 37.5),
    ("decode_step_ms.serve", 1e3 * 14.0 / 300),
])
def test_port_bench_reader_values(root, name, want):
    assert reader(root, name).read(RECORD) == pytest.approx(want)


def test_port_bench_shares_of_peaks_and_rooflines(root):
    art = 16 * ys.art_bytes(10_529_656, 19_456, 65_536, 16, 2)
    assert reader(root, "art_roofline.tomo").read(RECORD) == pytest.approx(
        100 * art / ys.PEAK_HBM_BYTES / 0.8)
    assert reader(root, "train_mfu").read(RECORD) == pytest.approx(
        100 * 40 * ys.model_flops_train(M, 4, 1024) / 20.0 / 989e12)
    assert reader(root, "prefill_mfu.serve").read(RECORD) == pytest.approx(
        100 * ys.model_flops_prefill(M, 4, 2048) / 0.3 / 989e12)
    # 24 calls, whatever number of kernels the trace credits to them
    flash = ys.flash_flops(4, 16, 2048, 128) / 989e12
    assert reader(root, "flash_roofline.serve").read(RECORD) == \
        pytest.approx(100 * 24 * flash / 0.04)
