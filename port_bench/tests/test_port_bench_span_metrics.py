"""The readers of the program's span log, on records and span logs built by
hand: each gives the number worked out below, and nothing where the run
carries no spans (a program without the span log)."""
import pytest

from port_bench import bench, spanlog


def reader(root, name):
    return bench.load_module(bench.reader_path(root, name),
                             f"test_span_metric_{name.replace('.', '_')}")


def batch(traced, *spans):
    """A batch as ``recent_batches`` gives it: (name, start, end,
    device_s) for each span."""
    return {"traced": traced, "spans": [
        {"name": n, "start": a, "end": b, "device_s": d}
        for n, a, b, d in spans]}


# four 51 ms kernels queued on one stream: the tasks wait 0, 51, 102 and
# 153 ms behind each other, so their walls are 51, 102, 153 and 204 ms
# against 204 ms of kernels: 1 - 0.204 / 0.510 = 60 %
TOMO_BATCH = batch(False, *[("task", 0.0, 0.051 * (i + 1), None)
                            for i in range(4)],
                   *[("art", 0.0, 0.0, 0.051)] * 4)


def test_port_bench_art_wait_share_reads_the_window_spans(root):
    read = reader(root, "art_wait_share.tomo").read
    assert read({"spans": [TOMO_BATCH] * 3}) == pytest.approx(60.0)


@pytest.mark.parametrize("rec", [
    {"trace": {}},
    # the parent's spans: stages only, no spans of their own
    {"spans": [{"total_s": 0.25, "stages": {"batch_fn": 0.2}}]},
    # on the CPU an ART call has no device time
    {"spans": [batch(False, ("task", 0.0, 0.1, None),
                     ("art", 0.0, 0.1, None))]},
])
def test_port_bench_art_wait_share_finds_nothing(root, rec):
    assert reader(root, "art_wait_share.tomo").read(rec) is None


# set-up's steps, the window's three (tracing off), the trace's dropped
# first step (off), two traced steps, and a second trace's dropped step
TRAIN_LOG = [
    batch(False, ("optimizer", 0, 1, 0.300)),
    batch(False, ("optimizer", 0, 1, 0.150)),
    batch(False, ("optimizer", 0, 1, 0.160)),
    batch(False, ("optimizer", 0, 1, 0.170)),
    batch(True, ("optimizer", 0, 1, 0.250)),
    batch(True, ("optimizer", 0, 1, 0.250)),
    batch(False, ("optimizer", 0, 1, 0.500)),
]
TRAIN_REC = {"window_units": 2,
             "trace": {"units": 2, "labels": {"adamw": 0.276}}}


def test_port_bench_optimizer_idle_reads_the_window_steps(root,
                                                          monkeypatch):
    monkeypatch.setattr(spanlog, "batches", lambda: TRAIN_LOG)
    # the last two steps with tracing off before the trace: 0.165 s of the
    # update's event pairs a step, against 0.138 s of its kernels
    assert reader(root, "optimizer_idle_ms.train").read(TRAIN_REC) == \
        pytest.approx(1e3 * (0.165 - 0.138))


@pytest.mark.parametrize("log, rec", [
    ([], TRAIN_REC),                          # the parent: no span log
    (TRAIN_LOG, {"trace": {}}),
    (TRAIN_LOG, {"window_units": 2, "trace": {"units": 2, "labels": {}}}),
    ([batch(False, ("optimizer", 0, 1, None))] * 3, TRAIN_REC),   # CPU
])
def test_port_bench_optimizer_idle_finds_nothing(root, monkeypatch, log,
                                                 rec):
    monkeypatch.setattr(spanlog, "batches", lambda: log)
    assert reader(root, "optimizer_idle_ms.train").read(rec) is None


# a window batch, then the traced batch: 3 decode steps of 2 layers
SERVE_LOG = [
    batch(False, *[("decode", 0, 1, None)] * 3),
    batch(True, ("prefill", 0, 1, None),
          *[("decode", 0, 1, None)] * 3,
          *[("decode_attention", 0, 1, d)
            for d in (0.010, 0.012, 0.011, 0.013, 0.009, 0.015)]),
]


def test_port_bench_decode_attention_reads_the_traced_steps(root,
                                                            monkeypatch):
    monkeypatch.setattr(spanlog, "batches", lambda: SERVE_LOG)
    read = reader(root, "decode_attention_ms.serve").read
    assert read({"trace": {"units": 1}}) == pytest.approx(1e3 * 0.070 / 3)


@pytest.mark.parametrize("log, rec", [
    ([], {"trace": {"units": 1}}),
    (SERVE_LOG, {"trace": {}}),
    (SERVE_LOG[:1], {"trace": {"units": 1}}),     # nothing traced
])
def test_port_bench_decode_attention_finds_nothing(root, monkeypatch, log,
                                                   rec):
    monkeypatch.setattr(spanlog, "batches", lambda: log)
    assert reader(root, "decode_attention_ms.serve").read(rec) is None


def test_port_bench_span_log_selects_the_window_and_the_trace():
    rec = {"window_units": 3, "trace": {"units": 2}}
    window = spanlog.window(rec, TRAIN_LOG)
    assert [b["spans"][0]["device_s"] for b in window] == [0.150, 0.160,
                                                          0.170]
    assert spanlog.traced(rec, TRAIN_LOG) == TRAIN_LOG[4:6]
    assert spanlog.window({}, TRAIN_LOG) == []
    assert spanlog.traced({}, TRAIN_LOG) == []


def test_port_bench_span_log_reads_the_program(root):
    """Through the program's accessor: a batch of a stream, its spans
    with their device times resolved (None on the CPU)."""
    from repro_torch.core.broker import Broker
    from repro_torch.core.dstream import StreamingContext
    from repro_torch.core.rdd import Context

    broker = Broker()
    broker.create_topic("t", partitions=1)
    sc = StreamingContext(Context(), broker, max_records_per_partition=4)
    sc.subscribe(["t"])
    sc.foreach_batch(lambda rdd, info: rdd.collect())
    for i in range(4):
        broker.produce("t", i)
    sc.run_one_batch()
    last = spanlog.batches()[-1]
    assert last["batch_index"] == sc.traces.last(1)[0].batch_index
    assert not last["traced"]
    assert [s["name"] for s in last["spans"]][:3] == ["batch", "pump",
                                                      "task"]
