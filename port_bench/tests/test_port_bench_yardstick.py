"""The benchmark's arithmetic against values worked by hand."""
import statistics

import pytest

from port_bench import loop
from port_bench import yardstick as ys

INTERNLM2 = {"num_layers": 24, "d_model": 2048, "num_heads": 16,
             "num_kv_heads": 8, "head_dim": 128, "d_ff": 8192,
             "vocab_size": 92544}


def test_port_bench_rate_is_all_the_work_over_all_the_time():
    assert ys.rate(2496, 10.0) == pytest.approx(249.6)
    assert ys.rate(5, 0.0) is None


def test_port_bench_window_ends_at_the_first_unit_boundary_after_it():
    clock = {"t": 0.0}

    def unit():
        clock["t"] += 0.4
        return 3

    import time
    real = time.perf_counter
    time.perf_counter = lambda: clock["t"]
    try:
        seconds, work, units = loop.window(unit, 1.0)
    finally:
        time.perf_counter = real
    # 0.4, 0.8, 1.2: the third unit crosses 1.0 and ends the window
    assert units == 3 and work == 9 and seconds == pytest.approx(1.2)


def test_port_bench_p95_is_over_every_request():
    values = list(range(1, 101))          # 1..100
    assert ys.percentile(values, 95) == pytest.approx(95.05)
    assert ys.percentile([7.0], 95) == 7.0
    assert ys.percentile([], 95) is None
    # one slow request in twenty moves the tail, whatever the chunking
    assert ys.percentile([1.0] * 19 + [9.0], 95) == pytest.approx(1.4)


def test_port_bench_spread_and_bound_follow_the_quartile_rule():
    values = [100, 101, 99, 102, 98, 100]
    q1, med, q3 = statistics.quantiles(values, n=4)
    assert ys.spread(values) == pytest.approx((q3 - q1) / med)
    assert ys.bound_from([0.001]) == 0.01           # never under 1 %
    assert ys.bound_from([0.004, 0.01]) == pytest.approx(0.05)
    assert ys.bound_from([0.2]) == 0.25


def test_port_bench_dense_counts_match_internlm2():
    assert ys.dense_param_count(INTERNLM2) == 1_889_110_016
    # 6·N·tokens + 6·B·S²·h·hd·L/2
    assert ys.model_flops_train(INTERNLM2, 4, 1024) == pytest.approx(
        6 * 1_889_110_016 * 4096 + 3 * 4 * 1024 ** 2 * 16 * 128 * 24)
    assert ys.model_flops_train(INTERNLM2, 4, 1024) == pytest.approx(
        4.70e13, rel=2e-3)
    assert ys.model_flops_train(INTERNLM2, 4, 4096) == pytest.approx(
        1.956e14, rel=2e-3)
    assert ys.model_flops_prefill(INTERNLM2, 16, 2048) == pytest.approx(
        1.27e14, rel=5e-3)


def test_port_bench_art_roofline_counts_match_the_kernel_table():
    # nray 256, 76 angles: 10,529,656 non-zeros; a stream launch of 16
    # slices and 2 sweeps needs 178 MB, 0.0533 ms at 3.35 TB/s
    nbytes = ys.art_bytes(10_529_656, 19_456, 65_536, 16, 2)
    assert nbytes == 2 * (10_529_656 * 8 + 19_457 * 8) + 16 * 19_456 * 4 \
        + 19_456 * 4 + 2 * 16 * 65_536 * 4
    least = ys.roofline_seconds(ys.art_flops(10_529_656, 16, 2), nbytes,
                                ys.PEAK_FP32_FLOPS)
    assert least * 1e3 == pytest.approx(0.0533, rel=5e-3)


def test_port_bench_flash_counts_at_the_prefill_shape():
    # B 16, H 16, S 2,048, hd 128: compute-bound
    flops = ys.flash_flops(16, 16, 2048, 128)
    assert flops == 4 * 16 * 16 * 128 * 2048 * 2049 // 2
    nbytes = ys.flash_bytes(16, 16, 2048, 128)
    assert nbytes == 4 * 16 * 2048 * 16 * 128 * 2
    least = ys.roofline_seconds(flops, nbytes, ys.PEAK_BF16_FLOPS)
    assert least == pytest.approx(flops / 989e12)
    # the kernel table's serving shape, B·H 64 at S 1,024: byte-bound
    assert ys.roofline_seconds(ys.flash_flops(4, 16, 1024, 128),
                               ys.flash_bytes(4, 16, 1024, 128),
                               ys.PEAK_BF16_FLOPS) * 1e3 == pytest.approx(
                                   0.0200, rel=2e-2)


def test_port_bench_share_is_in_percent():
    assert ys.share(1.0, 4.0) == 25.0
    assert ys.share(1.0, 0.0) is None
