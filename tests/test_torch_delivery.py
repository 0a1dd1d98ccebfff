"""The port's delivery lanes and sinks on the CPU: counterparts of
tests/test_delivery.py (slow sinks must not stall fast lanes, crashing sinks
are isolated per policy, queue-full block vs drop holds, a clean close()
drains every lane without losing batches or leaking threads), the sinks the
lanes carry, and the §III stream's artifact lane.

Every test runs with the port's lock tracing on and asserts afterwards that
the locks it took were acquired in no cyclic order.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.apps.ptycho.stream import parse_args, run_stream
from repro_torch.core.bridge import TorchBridge
from repro_torch.core.broker import Broker, OffsetRange
from repro_torch.core.dstream import StreamingContext
from repro_torch.core.pipeline import NearRealTimePipeline, PipelineConfig
from repro_torch.core.rdd import Context
from repro_torch.data import locktrace
from repro_torch.data.delivery import (DeliveryFailed, DeliveryRuntime,
                                       SinkPolicy)
from repro_torch.data.sinks import (CallbackSink, MetricsSink,
                                    NpzDirectorySink, Sink, TopicSink,
                                    fan_out)
from repro_torch.data.sources import SequenceSource


@pytest.fixture(autouse=True)
def port_lock_order():
    """The port's counterpart of tests/conftest.py's harness: traced locks
    for the test, and no lock-order cycle at the end."""
    locktrace.enable()
    try:
        yield
    finally:
        report = locktrace.disable().report()
    assert not report.cycles, (
        "lock-order cycles detected (potential deadlock):\n"
        + report.describe())


class _Counter(SequenceSource):
    """``total`` records ``(b"rec-%06d", i)``, as fast as polled."""

    def __init__(self, total: int) -> None:
        super().__init__()
        self._total = total

    def __len__(self) -> int:
        return self._total

    def record_at(self, i: int):
        return f"rec-{i:06d}".encode(), i


class ChaosSink:
    """Keyed sink with injectable latency and failures."""

    def __init__(self, sleep: float = 0.0, fail: bool = False,
                 fail_first: int = 0) -> None:
        self.sleep = sleep
        self.fail = fail
        self.fail_first = fail_first     # fail the first N calls, then heal
        self.calls = 0
        self.batches: list[list] = []
        self.closed = False
        self._lock = threading.Lock()

    def write_batch(self, items):
        with self._lock:
            self.calls += 1
            calls = self.calls
        if self.sleep:
            time.sleep(self.sleep)
        if self.fail or calls <= self.fail_first:
            raise RuntimeError(f"chaos(call={calls})")
        with self._lock:
            self.batches.append(list(items))
        return len(items)

    def close(self):
        self.closed = True


class FakeInfo:
    """Minimal BatchInfo stand-in for driving the runtime directly."""

    def __init__(self, index):
        self.index = index
        self.result = [(f"k{index:04d}", index)]
        self.num_records = 1
        self.processing_time = 0.001


def _submit_all(runtime, n):
    for i in range(n):
        runtime.submit(FakeInfo(i))


def _pipeline(broker, total, sinks, interval=0.005):
    """Source -> trivial keyed process -> the given sinks/(sink, policy)s."""
    pipe = NearRealTimePipeline(
        broker,
        PipelineConfig(batch_interval=interval, max_records_per_partition=4),
        lambda rdd, info, bridge: [(f"rec-{v:04d}", v)
                                   for v in rdd.collect()],
        bridge=TorchBridge(device=torch.device("cpu")),
        sinks=sinks)
    pipe.subscribe_source(_Counter(total))
    return pipe


# -- chaos: the slow sink -----------------------------------------------------

def test_torch_delivery_slow_sink_does_not_stall_fast_lane():
    """One sink sleeping 100x the batch interval: the fast lane's per-batch
    delivery latency stays within 2x the all-fast baseline (plus scheduler
    slack), nowhere near the slow sink's serial cost."""
    interval = 0.005
    slow_s = 100 * interval
    batches = 8

    def run(slow_sleep):
        fast = ChaosSink()
        slow = ChaosSink(sleep=slow_sleep)
        rt = DeliveryRuntime()
        rt.add_sink(fast, SinkPolicy.skip_batch(queue_depth=batches),
                    name="fast")
        rt.add_sink(slow, SinkPolicy.skip_batch(queue_depth=batches,
                                                on_full="block"),
                    name="slow")
        _submit_all(rt, batches)
        # metrics path = the fast lane: wait only for it
        deadline = time.monotonic() + 5
        while (len(fast.batches) < batches
               and time.monotonic() < deadline):
            time.sleep(0.001)
        fast_latency = max(rt.lanes[0].metrics.latencies, default=0.0)
        rt.close(drain=True)
        assert len(fast.batches) == batches
        return fast_latency, slow

    baseline, _ = run(0.0)
    chaos, slow = run(slow_s)
    # 2x the baseline, with a floor absorbing scheduler jitter on a loaded
    # CI box; the real claim is the fast lane never waits on the slow one
    assert chaos <= max(2 * baseline, 0.05)
    assert chaos < slow_s                       # not even ONE slow write
    assert len(slow.batches) == batches         # and the slow lane drained


def test_torch_delivery_slow_sink_pipeline_end_to_end_latency():
    """Same claim through NearRealTimePipeline: streaming wall-clock with a
    100x-slow policy'd sink stays within 2x the all-fast run, far under the
    slow sink's serial cost, and close() still lands every batch."""
    interval = 0.005
    slow_s = 100 * interval

    def run(slow_sleep):
        fast = ChaosSink()
        slow = ChaosSink(sleep=slow_sleep)
        metrics = MetricsSink()
        pipe = _pipeline(
            Broker(), 24,
            [metrics,
             (fast, SinkPolicy.skip_batch(queue_depth=64)),
             (slow, SinkPolicy.skip_batch(queue_depth=64))],
            interval=interval)
        t0 = time.perf_counter()
        report = pipe.run_until_drained()
        wall = time.perf_counter() - t0
        pipe.close(drain=True)
        assert report.records == 24
        assert len(slow.batches) == report.batches   # drained at close
        return wall, report.batches

    base_wall, base_batches = run(0.0)
    chaos_wall, chaos_batches = run(slow_s)
    serial_cost = chaos_batches * slow_s
    assert chaos_wall <= max(2 * base_wall, base_wall + 0.25)
    assert chaos_wall < serial_cost / 2


# -- chaos: the crashing sink -------------------------------------------------

def test_torch_delivery_crashing_sink_dead_letters_and_pipeline_completes():
    broker = Broker()
    good = ChaosSink()
    bad = ChaosSink(fail=True)
    pipe = _pipeline(
        broker, 20,
        [good,
         (bad, SinkPolicy.dead_letter("dlq", retries=1, queue_depth=64))])
    report = pipe.run_until_drained()
    pipe.close(drain=True)                       # completes, does NOT raise
    assert report.records == 20                  # pipeline reports success
    lane = pipe.delivery_report()["ChaosSink"]
    assert lane["failed"] == report.batches
    assert lane["dead_lettered"] == report.batches
    assert lane["retries"] == report.batches     # one retry each, then DLQ
    # every failed batch's items landed on the dead-letter topic, key intact
    n = broker.end_offset("dlq")
    assert n == report.records
    recs = broker.read(OffsetRange("dlq", 0, 0, n))
    assert {r.key for r in recs} == {f"rec-{v:04d}".encode()
                                     for v in range(20)}
    assert all(r.value["sink"] == "ChaosSink" and "chaos" in r.value["error"]
               for r in recs)
    assert sorted(r.value["value"] for r in recs) == list(range(20))
    # the healthy sink never noticed
    assert sum(len(b) for b in good.batches) == 20


def test_torch_delivery_retry_then_success_recovers_without_dead_letter():
    broker = Broker()
    flaky = ChaosSink(fail_first=2)              # first two calls fail
    rt = DeliveryRuntime(broker)
    rt.add_sink(flaky, SinkPolicy.retry(3, then="dead_letter",
                                        dead_letter_topic="dlq"))
    rt.submit(FakeInfo(0))
    rt.close(drain=True)
    m = rt.lanes[0].metrics
    assert m.delivered == 1 and m.failed == 0 and m.dead_lettered == 0
    assert m.retries == 2
    assert "dlq" not in broker.topics()          # never needed


def test_torch_delivery_fail_pipeline_policy_aborts():
    pipe = _pipeline(
        Broker(), 40,
        [(ChaosSink(fail=True), SinkPolicy.fail_pipeline(queue_depth=64))])
    with pytest.raises(DeliveryFailed):
        pipe.run_until_drained()
        pipe.close(drain=True)   # if the run outraced the lane, close raises


def test_torch_delivery_blocked_enqueue_is_interrupted_by_fail_pipeline():
    """Batch thread blocked in a full on_full="block" queue while ANOTHER
    lane's fail_pipeline verdict lands: the blocked submit must raise
    DeliveryFailed promptly instead of waiting out the wedged sink."""
    rt = DeliveryRuntime()
    rt.add_sink(ChaosSink(sleep=5.0),
                SinkPolicy.skip_batch(queue_depth=1, on_full="block"),
                name="wedged")
    rt.add_sink(ChaosSink(sleep=0.2, fail=True),
                SinkPolicy.fail_pipeline(queue_depth=8), name="fatal")
    t0 = time.perf_counter()
    with pytest.raises(DeliveryFailed):
        _submit_all(rt, 4)     # blocks on lane "wedged" by the 3rd submit
    assert time.perf_counter() - t0 < 2.0
    assert rt.report()["fatal"]["failed"] >= 1
    with pytest.raises(DeliveryFailed):     # close re-raises the verdict
        rt.close(drain=False, timeout=0.5)


def test_torch_delivery_zero_timeout_means_immediate_deadline_not_infinite():
    wedged = ChaosSink(sleep=30.0)
    rt = DeliveryRuntime()
    lane = rt.add_sink(wedged, SinkPolicy.skip_batch(queue_depth=1,
                                                     on_full="drop"))
    _submit_all(rt, 3)
    time.sleep(0.05)           # worker wedges; queue stays full
    t0 = time.perf_counter()
    assert rt.drain(timeout=0.0) is False
    rt.close(drain=False, timeout=0.0)
    assert time.perf_counter() - t0 < 0.5
    assert lane.metrics.leaked_thread


def test_torch_delivery_skip_batch_isolates_failures_to_one_lane():
    rt = DeliveryRuntime()
    good, bad = ChaosSink(), ChaosSink(fail=True)
    rt.add_sink(good, SinkPolicy.skip_batch(), name="good")
    rt.add_sink(bad, SinkPolicy.skip_batch(), name="bad")
    _submit_all(rt, 12)
    rt.close(drain=True)
    assert len(good.batches) == 12
    rep = rt.report()
    assert rep["bad"]["failed"] == 12 and rep["bad"]["delivered"] == 0
    assert rep["good"]["failed"] == 0 and rep["good"]["delivered"] == 12


# -- queue-full semantics -----------------------------------------------------

def test_torch_delivery_queue_full_drop_sheds_batches():
    slow = ChaosSink(sleep=0.02)
    rt = DeliveryRuntime()
    lane = rt.add_sink(slow, SinkPolicy.skip_batch(queue_depth=2,
                                                   on_full="drop"))
    t0 = time.perf_counter()
    _submit_all(rt, 12)
    submit_wall = time.perf_counter() - t0
    rt.close(drain=True)
    m = lane.metrics
    assert submit_wall < 0.02 * 6                # submits never blocked long
    assert m.dropped_full > 0                    # pressure was shed...
    assert m.delivered + m.dropped_full == 12    # ...and fully accounted
    assert len(slow.batches) == m.delivered


def test_torch_delivery_queue_full_block_applies_backpressure_and_loses_nothing():
    slow = ChaosSink(sleep=0.02)
    rt = DeliveryRuntime()
    lane = rt.add_sink(slow, SinkPolicy.skip_batch(queue_depth=2,
                                                   on_full="block"))
    t0 = time.perf_counter()
    _submit_all(rt, 10)
    submit_wall = time.perf_counter() - t0
    rt.close(drain=True)
    assert submit_wall >= 0.02 * 4               # the batch thread DID wait
    assert lane.metrics.dropped_full == 0
    assert len(slow.batches) == 10               # lossless


# -- timeouts -----------------------------------------------------------------

def test_torch_delivery_sink_timeout_is_a_failure_and_wedged_lane_fails_fast():
    broker = Broker()
    stuck = ChaosSink(sleep=0.5)
    rt = DeliveryRuntime(broker)
    lane = rt.add_sink(
        stuck, SinkPolicy.dead_letter("dlq", timeout=0.05, queue_depth=8))
    _submit_all(rt, 3)
    rt.drain(timeout=2)
    t0 = time.perf_counter()
    rt.close(drain=True, timeout=2.0)
    assert time.perf_counter() - t0 < 2.5        # close never hung on it
    m = lane.metrics
    assert m.delivered == 0 and m.failed == 3    # timeout + 2x wedged
    assert m.dead_lettered == 3
    assert broker.end_offset("dlq") == 3
    assert "Timeout" in m.last_error or "wedged" in m.last_error


# -- clean shutdown -----------------------------------------------------------

def test_torch_delivery_close_drains_all_lanes_no_lost_batches_no_leaked_threads():
    before = threading.active_count()
    sinks = [ChaosSink(), ChaosSink(sleep=0.005), ChaosSink()]
    rt = DeliveryRuntime()
    lanes = [rt.add_sink(s, SinkPolicy.skip_batch(queue_depth=64),
                         name=f"lane-{i}") for i, s in enumerate(sinks)]
    _submit_all(rt, 20)
    rt.close(drain=True)
    for sink, lane in zip(sinks, lanes):
        assert len(sink.batches) == 20           # no lost batches
        assert sink.closed                       # sink.close() propagated
        assert not lane.thread.is_alive()        # no leaked threads
        assert not lane.metrics.leaked_thread
    assert threading.active_count() == before
    rt.close(drain=True)                         # idempotent


def test_torch_delivery_close_honors_timeout_with_wedged_sink_and_full_queue():
    """A sink hung in write_batch with a full lane queue: close() must
    return within its timeout (abandoning the daemon worker), not block
    forever on the shutdown sentinel."""
    wedged = ChaosSink(sleep=30.0)
    rt = DeliveryRuntime()
    lane = rt.add_sink(wedged, SinkPolicy.skip_batch(queue_depth=1,
                                                     on_full="drop"))
    _submit_all(rt, 3)          # 1 in flight (hung), 1 queued, 1 dropped
    time.sleep(0.05)            # let the worker wedge into the sleep
    t0 = time.perf_counter()
    rt.close(drain=True, timeout=0.3)
    assert time.perf_counter() - t0 < 1.0
    assert lane.metrics.leaked_thread


def test_torch_delivery_metrics_sink_with_policy_keeps_both_surfaces():
    """MetricsSink exposes observe AND write_batch; the policy path must
    register both (an observe lane and a keyed lane), like the serial path."""
    metrics = MetricsSink()
    pipe = _pipeline(Broker(), 12, [(metrics, SinkPolicy.skip_batch())])
    report = pipe.run_until_drained()
    pipe.close(drain=True)
    assert metrics.batches == report.batches     # observe lane ran
    assert metrics.items == 12                   # keyed lane ran too
    assert set(pipe.delivery_report()) == {"MetricsSink-observe",
                                           "MetricsSink"}


def test_torch_delivery_close_without_drain_discards_fast():
    slow = ChaosSink(sleep=0.05)
    rt = DeliveryRuntime()
    lane = rt.add_sink(slow, SinkPolicy.skip_batch(queue_depth=32))
    _submit_all(rt, 20)
    t0 = time.perf_counter()
    rt.close(drain=False, timeout=5.0)
    assert time.perf_counter() - t0 < 0.05 * 10  # did not write all 20
    m = lane.metrics
    assert m.discarded > 0
    assert m.delivered + m.discarded == 20       # accounted, just not written


# -- StreamingContext-level wiring --------------------------------------------

def test_torch_delivery_streaming_context_policy_sink_rides_a_lane():
    broker = Broker()
    sc = StreamingContext(Context(), broker, max_records_per_partition=4)
    sc.subscribe_source(_Counter(12), topic="t")
    sc.foreach_batch(lambda rdd, info: len(rdd.collect()))
    seen = []
    sc.add_sink(seen.append, policy=SinkPolicy.skip_batch(), name="probe")
    while not (sc.sources_exhausted and sc.lag("t") == 0):
        sc.run_one_batch()
    sc.close(drain=True)
    assert [i.index for i in seen] == [b.index for b in sc.history]
    assert sc.delivery.report()["probe"]["delivered"] == len(sc.history)


# -- report() counter semantics -----------------------------------------------

def test_torch_delivery_report_counter_semantics_under_concurrent_lanes():
    """Three lanes running concurrently — healthy, slow, crash-then-heal —
    report() returns exact per-lane counters. (The reference also holds its
    registry's ``delivery_*`` instruments to them; the port has no registry
    yet.)"""
    runtime = DeliveryRuntime()
    ok, slow = ChaosSink(), ChaosSink(sleep=0.02)
    # fails calls 1-3: batch 0 burns both attempts (terminal failure),
    # batch 1 fails once then heals on its retry, batches 2-5 are clean
    flaky = ChaosSink(fail_first=3)
    runtime.add_sink(ok, SinkPolicy(), name="ok")
    runtime.add_sink(slow, SinkPolicy(), name="slow")
    runtime.add_sink(flaky, SinkPolicy(retries=1), name="flaky")
    _submit_all(runtime, 6)
    assert runtime.drain(timeout=30)
    rep = runtime.report()

    assert rep["ok"]["enqueued"] == 6 and rep["ok"]["delivered"] == 6
    assert rep["ok"]["failed"] == 0 and rep["ok"]["retries"] == 0
    assert rep["slow"]["delivered"] == 6
    assert rep["slow"]["mean_write_s"] >= 0.02
    assert rep["flaky"]["enqueued"] == 6
    assert rep["flaky"]["delivered"] == 5    # batch 1 healed on retry
    assert rep["flaky"]["failed"] == 1       # batch 0 exhausted retries
    assert rep["flaky"]["retries"] == 2      # one re-attempt per failure
    assert "chaos" in rep["flaky"]["last_error"]
    for lane in rep.values():
        assert lane["depth"] == 0            # drained
        assert lane["dropped_full"] == 0 and lane["dead_lettered"] == 0
    assert rep["ok"]["max_latency_s"] >= rep["ok"]["mean_latency_s"] > 0

    runtime.close()


def test_torch_delivery_serial_sinks_unaffected_by_delivery_runtime():
    """No policy => the degenerate serial path: no lanes, no threads."""
    before = threading.active_count()
    pipe = _pipeline(Broker(), 8, [ChaosSink()])
    pipe.run_until_drained()
    assert pipe.delivery_report() == {}
    assert threading.active_count() == before
    pipe.close()                                 # harmless no-op


# -- the sinks the lanes carry (repro/data/sinks.py) ---------------------------
def test_torch_topic_sink_feeds_a_downstream_topic_once_per_key():
    broker = Broker()
    sink = TopicSink(broker, "results", partitions=2)
    assert isinstance(sink, Sink)
    assert sink.write_batch([("a", 1), ("b", 2), ("c", 3)]) == 3
    assert sink.write_batch([("b", 2), ("d", 4)]) == 1        # b deduped
    assert (sink.written, sink.skipped) == (4, 1)
    assert broker.end_offsets("results") == [2, 2]            # round-robin
    recs = broker.read(OffsetRange("results", 0, 0, 2)) \
        + broker.read(OffsetRange("results", 1, 0, 2))
    assert sorted((r.key, r.value) for r in recs) == [
        (b"a", 1), (b"b", 2), (b"c", 3), (b"d", 4)]


def test_torch_callback_sink_and_fan_out(tmp_path):
    seen = []
    cb = CallbackSink(lambda k, v: seen.append((k, v)))
    npz = NpzDirectorySink(str(tmp_path / "npz"))
    write = fan_out([cb, npz, MetricsSink()])
    assert write([("x", np.arange(3)), ("y", 2.5)]) == 4   # metrics: 0
    assert write([("x", np.arange(3))]) == 0               # idempotent
    assert [k for k, _ in seen] == ["x", "y"]
    assert npz.keys_on_disk() == ["x", "y"]


def test_torch_lane_from_pipeline_policy_tuple_writes_every_batch(tmp_path):
    """A ``(sink, SinkPolicy)`` pair moves the sink onto a lane; close()
    lands every batch on disk, and the sink's keys match a serial run's."""
    lanes, serial = NpzDirectorySink(str(tmp_path / "lane")), \
        NpzDirectorySink(str(tmp_path / "serial"))
    for sink in ((lanes, SinkPolicy.retry(2, queue_depth=32)), serial):
        pipe = _pipeline(Broker(), 30, [sink])
        pipe.run_until_drained()
        pipe.close()
    assert lanes.keys_on_disk() == serial.keys_on_disk()
    assert len(lanes.keys_on_disk()) == 30


def test_torch_stream_main_path_artifact_lane(tmp_path):
    """The §III stream puts the artifact store on a retry(2) lane of depth
    32: every batch is delivered before the refinement tail, none fails,
    and the sink holds one key a batch plus object-final."""
    res = run_stream(parse_args(["--fast", "--out", str(tmp_path)]),
                     device="cpu")
    batches = len(res["batch_errors"])
    assert set(res["lanes"]) == {"NpzDirectorySink"}
    lane = res["lanes"]["NpzDirectorySink"]
    assert (lane["enqueued"], lane["delivered"], lane["failed"],
            lane["retries"], lane["dropped_full"]) == (batches, batches, 0,
                                                       0, 0)
    assert lane["depth"] == 0
    assert res["sink_keys"] == [f"batch-{i:06d}" for i in range(batches)] \
        + ["object-final"]
