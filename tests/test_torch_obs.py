"""The port's metrics registry, trace spans and observability endpoint on the
CPU: the counterparts of tests/test_metrics.py and tests/test_obs_server.py,
and the same small pipeline built from each package's classes with fresh
registries, whose endpoints must serve the same metric names, labels and
kinds, the same counter values and the same span stages.

Every test runs with the port's lock tracing on and asserts afterwards that
the locks it took were acquired in no cyclic order.
"""
import json
import math
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.core.fault import LagPolicy
from repro_torch.core.broker import Broker
from repro_torch.core.dstream import StreamingContext
from repro_torch.core.rdd import Context
from repro_torch.data import locktrace
from repro_torch.data.delivery import SinkPolicy
from repro_torch.data.ingest import IngestConfig, IngestRunner
from repro_torch.data.metrics import (COUNT_BUCKETS, DEFAULT_BUCKETS,
                                      SPAN_STAGES, BatchSpan, Histogram,
                                      MetricsRegistry, NullRegistry, TraceLog,
                                      disabled, get_registry, set_registry)
from repro_torch.data.obs_server import (ObservabilityServer, lag_health,
                                         scrape_stream)
from repro_torch.data.sources import ProjectionSource
from repro_torch.data.state import DurableStateStore
from repro_torch.data.transport import RemoteBroker, serve_broker
from repro_torch.data.window import WindowSpec, windowed


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


@pytest.fixture
def registry():
    """Fresh process-wide registry per test: components constructed inside
    the test register here, not into state leaked by earlier tests."""
    reg = MetricsRegistry()
    prev = set_registry(reg)
    yield reg
    set_registry(prev)


# -- registry identity (tests/test_metrics.py) -------------------------------------

def test_torch_metrics_get_or_create_returns_same_instrument():
    reg = MetricsRegistry()
    a = reg.counter("hits_total", "help once")
    b = reg.counter("hits_total", "ignored on re-register")
    assert a is b
    a.inc(3)
    assert b.value() == 3


def test_torch_metrics_identity_is_name_plus_labels_order_insensitive():
    reg = MetricsRegistry()
    a = reg.counter("c", labels={"topic": "t", "part": "0"})
    b = reg.counter("c", labels={"part": "0", "topic": "t"})
    c = reg.counter("c", labels={"topic": "other"})
    assert a is b
    assert c is not a
    assert len(reg.metrics()) == 2


def test_torch_metrics_kind_mismatch_is_an_error():
    reg = MetricsRegistry()
    reg.counter("x")
    with pytest.raises(ValueError, match="already registered as counter"):
        reg.gauge("x")


def test_torch_metrics_counter_monotonic():
    c = MetricsRegistry().counter("n_total")
    c.inc()
    c.inc(4)
    assert c.value() == 5
    with pytest.raises(ValueError):
        c.inc(-1)


def test_torch_metrics_gauge_set_inc_dec():
    g = MetricsRegistry().gauge("depth")
    g.set(10)
    g.inc(2)
    g.dec(5)
    assert g.value() == 7


def test_torch_metrics_callback_gauge_reads_live_and_latest_wins():
    reg = MetricsRegistry()
    box = {"v": 1}
    g = reg.gauge("live", callback=lambda: box["v"])
    box["v"] = 42
    assert g.value() == 42
    g2 = reg.gauge("live", callback=lambda: 7)
    assert g2 is g
    assert g.value() == 7


def test_torch_metrics_dead_callback_gauge_is_nan_not_a_crash():
    g = MetricsRegistry().gauge(
        "dead", callback=lambda: (_ for _ in ()).throw(RuntimeError("gone")))
    assert math.isnan(g.value())
    reg = MetricsRegistry()
    reg.gauge("dead", callback=lambda: 1 / 0)
    (entry,) = reg.snapshot()["metrics"]
    assert entry["value"] is None


def test_torch_metrics_histogram_buckets_sum_count():
    h = MetricsRegistry().histogram("lat_seconds", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.05, 0.5, 99.0):
        h.observe(v)
    snap = h.snapshot()
    assert snap["buckets"] == [0.01, 0.1, 1.0]
    assert snap["counts"] == [1, 3, 4, 5]      # cumulative, last is +Inf
    assert snap["count"] == 5
    assert snap["sum"] == pytest.approx(99.605)
    assert h.value() == 5


def test_torch_metrics_histogram_timer_context():
    h = MetricsRegistry().histogram("t_seconds")
    with h.time():
        pass
    snap = h.snapshot()
    assert snap["count"] == 1
    assert 0 <= snap["sum"] < 1.0


def test_torch_metrics_count_buckets_cover_flush_sizes():
    h = MetricsRegistry().histogram("flush", buckets=COUNT_BUCKETS)
    h.observe(64)
    snap = h.snapshot()
    i = snap["buckets"].index(64)
    assert snap["counts"][i] == 1
    assert snap["counts"][i - 1] == 0


def test_torch_metrics_counter_thread_safety():
    c = MetricsRegistry().counter("n")
    threads = [threading.Thread(target=lambda: [c.inc() for _ in range(1000)])
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value() == 8000


def test_torch_metrics_prometheus_text_format():
    reg = MetricsRegistry(namespace="repro")
    reg.counter("reads_total", "records read",
                labels={"topic": "t"}).inc(3)
    reg.gauge("depth").set(2)
    reg.histogram("lat_seconds", buckets=(0.1, 1.0)).observe(0.05)
    text = reg.prometheus_text()
    assert "# HELP repro_reads_total records read" in text
    assert "# TYPE repro_reads_total counter" in text
    assert 'repro_reads_total{topic="t"} 3' in text
    assert "repro_depth 2" in text
    assert 'repro_lat_seconds_bucket{le="0.1"} 1' in text
    assert 'repro_lat_seconds_bucket{le="+Inf"} 1' in text
    assert "repro_lat_seconds_sum 0.05" in text
    assert "repro_lat_seconds_count 1" in text


def test_torch_metrics_snapshot_shape():
    reg = MetricsRegistry()
    reg.counter("c", "h", labels={"a": "b"}).inc()
    reg.sample(now=1.0)
    snap = reg.snapshot()
    assert set(snap) == {"sampled_at", "metrics"}
    (m,) = snap["metrics"]
    assert m["name"] == "c" and m["kind"] == "counter"
    assert m["labels"] == {"a": "b"} and m["value"] == 1
    assert m["series"] == [(1.0, 1)]


def test_torch_metrics_ring_buffer_series_is_bounded():
    reg = MetricsRegistry(ring_size=4)
    c = reg.counter("c")
    for i in range(10):
        c.inc()
        reg.sample(now=float(i))
    pts = c.series_points()
    assert len(pts) == 4
    assert [t for t, _ in pts] == [6.0, 7.0, 8.0, 9.0]
    assert [v for _, v in pts] == [7, 8, 9, 10]


def test_torch_metrics_null_registry_absorbs_everything():
    reg = NullRegistry()
    c = reg.counter("c")
    c.inc()
    reg.gauge("g").set(5)
    h = reg.histogram("h")
    h.observe(1.0)
    with h.time():
        pass
    assert reg.metrics() == []
    assert reg.snapshot()["metrics"] == []
    assert reg.prometheus_text() == "\n"


def test_torch_metrics_set_registry_returns_previous_and_disabled_restores():
    base = get_registry()
    mine = MetricsRegistry()
    prev = set_registry(mine)
    try:
        assert prev is base
        assert get_registry() is mine
        with disabled() as null:
            assert isinstance(null, NullRegistry)
            assert get_registry() is null
            Broker().create_topic("t")        # registers into nothing
        assert get_registry() is mine
        assert mine.metrics() == []
    finally:
        set_registry(prev)
    assert get_registry() is base


def test_torch_metrics_span_stages_cover_the_documented_pipeline_order():
    assert SPAN_STAGES == ("pump", "batch_fn", "sinks", "state_commit",
                           "checkpoint", "broker_commit", "delivery_submit")


def test_torch_metrics_span_recorder_builds_and_records_a_span():
    log = TraceLog()
    rec = log.begin(batch_index=3, num_records=17)
    rec.add("pump", 0.25)
    rec.add("pump", 0.25)
    with rec.stage("batch_fn"):
        pass
    with rec.stage("batch_fn"):
        pass
    span = rec.finish(epoch=9)
    assert span.batch_index == 3 and span.num_records == 17
    assert span.epoch == 9
    assert span.stages["pump"] == pytest.approx(0.5)
    assert span.stages["batch_fn"] >= 0
    assert span.total_s >= 0
    assert log.last() == [span]
    assert log.recorded == 1
    d = span.as_dict()
    assert set(d) == {"batch_index", "epoch", "num_records", "started_at",
                      "total_s", "stages"}


def test_torch_metrics_trace_log_capacity_and_last_n():
    log = TraceLog(capacity=3)
    for i in range(5):
        log.begin(i, 1).finish(epoch=i + 1)
    spans = log.last()
    assert [s.batch_index for s in spans] == [2, 3, 4]
    assert log.recorded == 5
    assert [s.batch_index for s in log.last(2)] == [3, 4]
    assert log.last(0) == []


def test_torch_metrics_stage_totals_roll_up_across_spans():
    log = TraceLog()
    for i in range(3):
        rec = log.begin(i, 1)
        rec.add("batch_fn", 0.1)
        rec.add("sinks", 0.01)
        rec.finish(epoch=i + 1)
    totals = log.stage_totals()
    assert totals["batch_fn"] == pytest.approx(0.3)
    assert totals["sinks"] == pytest.approx(0.03)


def test_torch_metrics_unfinished_span_is_not_recorded():
    log = TraceLog()
    rec = log.begin(0, 4)
    rec.add("pump", 0.1)
    assert log.last() == []
    assert log.recorded == 0
    assert isinstance(rec.span, BatchSpan)


def test_torch_metrics_default_buckets_are_sorted_and_nonempty():
    assert list(DEFAULT_BUCKETS) == sorted(DEFAULT_BUCKETS)
    assert DEFAULT_BUCKETS and COUNT_BUCKETS
    with pytest.raises(ValueError):
        Histogram("h", "", (), 8, buckets=())


# -- the endpoint (tests/test_obs_server.py) ---------------------------------------

def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def _get_json(url):
    status, body = _get(url)
    return status, json.loads(body)


def test_torch_obs_all_routes_serve(registry):
    registry.counter("hits_total", "requests").inc(5)
    registry.gauge("depth", callback=lambda: 3)
    registry.histogram("lat_seconds").observe(0.01)
    traces = TraceLog()
    rec = traces.begin(0, 8)
    rec.add("batch_fn", 0.1)
    rec.finish(epoch=1)
    with ObservabilityServer(registry, traces=traces) as srv:
        status, text = _get(srv.url + "/metrics")
        text = text.decode()
        assert status == 200
        assert "repro_hits_total 5" in text
        assert "repro_depth 3" in text
        assert "repro_lat_seconds_count 1" in text

        status, snap = _get_json(srv.url + "/metrics.json")
        assert status == 200
        names = {m["name"] for m in snap["metrics"]}
        assert names == {"hits_total", "depth", "lat_seconds"}
        assert all(len(m["series"]) == 2 for m in snap["metrics"])

        status, spans = _get_json(srv.url + "/traces")
        assert status == 200
        assert spans["recorded"] == 1
        assert spans["spans"][0]["epoch"] == 1
        assert spans["spans"][0]["stages"]["batch_fn"] == pytest.approx(0.1)

        status, health = _get_json(srv.url + "/health")
        assert status == 200
        assert health == {"status": "ok", "topics": {}}


def test_torch_obs_unknown_route_404_lists_routes(registry):
    with ObservabilityServer(registry) as srv:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url + "/nope")
        assert e.value.code == 404
        body = json.loads(e.value.read())
        assert "/metrics" in body["routes"] and "/health" in body["routes"]


def test_torch_obs_traces_bad_last_is_400_and_last_n_limits(registry):
    traces = TraceLog()
    for i in range(5):
        traces.begin(i, 1).finish(epoch=i + 1)
    with ObservabilityServer(registry, traces=traces) as srv:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url + "/traces?last=abc")
        assert e.value.code == 400
        status, body = _get_json(srv.url + "/traces?last=2")
        assert status == 200
        assert [s["batch_index"] for s in body["spans"]] == [3, 4]
        assert body["recorded"] == 5


def test_torch_obs_start_is_idempotent_and_stop_releases(registry):
    srv = ObservabilityServer(registry).start()
    addr = srv.address
    assert srv.start() is srv and srv.address == addr
    url = srv.url
    srv.stop()
    srv.stop()
    with pytest.raises(urllib.error.URLError):
        _get(url + "/health", timeout=2)
    with pytest.raises(RuntimeError):
        ObservabilityServer(registry).url


def test_torch_obs_lag_health_degrades_on_watermark(registry):
    """``lag_policy`` is duck-typed: the reference's ``LagPolicy`` serves."""
    lags = {"frames": 0}
    policy = LagPolicy(100, 10, sustain=3, cooldown=5.0)
    with ObservabilityServer(
            registry, health_fn=lag_health(lambda: lags, policy)) as srv:
        status, body = _get_json(srv.url + "/health")
        assert status == 200
        assert body["topics"]["frames"] == {
            "lag": 0, "scale_up_lag": 100, "scale_down_lag": 10, "ok": True}
        lags["frames"] = 100
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url + "/health")
        assert e.value.code == 503
        body = json.loads(e.value.read())
        assert body["status"] == "degraded"
        assert body["topics"]["frames"]["ok"] is False


def test_torch_obs_lag_health_without_policy_never_degrades():
    health = lag_health(lambda: {"t": 10 ** 9})
    assert health()["status"] == "ok"


def test_torch_obs_lag_health_survives_torn_down_context():
    def lag_of():
        raise RuntimeError("context closed")
    verdict = lag_health(lag_of, LagPolicy(100, 10))()
    assert verdict["status"] == "degraded"
    assert "context closed" in verdict["error"]


def test_torch_obs_windowed_pipeline_over_transport_exposes_every_layer(
        registry, tmp_path):
    """ProjectionSource -> IngestRunner -> BrokerServer/RemoteBroker ->
    windowed batch fn with a DurableStateStore -> delivery lane, observed
    live: broker, transport, ingest, delivery, state and stream metrics on
    ``/metrics``, batch spans on ``/traces`` tagged with the checkpoint
    epoch, ``/health`` judged against the lag policy."""
    broker = Broker()
    server = serve_broker(broker, str(tmp_path / "b.sock"))
    client = RemoteBroker(server.address)
    sc = StreamingContext(Context(), client, max_records_per_partition=8,
                          checkpoint_path=str(tmp_path / "ckpt"))
    try:
        runner = IngestRunner(client, consumer=sc)
        runner.add(ProjectionSource(np.arange(64.0).reshape(64, 1)),
                   IngestConfig(topic="frames", poll_batch=16,
                                flush_records=8))
        sc.subscribe(["frames"])
        windows = []
        store = DurableStateStore(str(tmp_path / "state"))
        sc.foreach_batch(windowed(
            WindowSpec(size=16),
            lambda recs, info: windows.append(len(recs)), store=store))
        sc.add_sink(lambda info: None, policy=SinkPolicy(), name="probe")
        policy = LagPolicy(1000, 10, sustain=3, cooldown=5.0)
        obs = sc.serve_observability(("127.0.0.1", 0), lag_policy=policy)
        assert sc.serve_observability() is obs

        ticks = 0
        while not (runner.done and sc.lag("frames") == 0):
            runner.pump()
            sc.run_one_batch()
            ticks += 1
            assert ticks < 500, "pipeline never drained"
        assert windows == [16, 16, 16, 16]
        assert sc.delivery.drain(timeout=10)

        _, text = _get(obs.url + "/metrics")
        text = text.decode()
        for line in (
                'repro_broker_produce_records_total{topic="frames"} 64',
                'repro_broker_read_records_total{topic="frames"} 64',
                'repro_broker_lag{topic="frames"} 0',
                "repro_transport_requests_total",
                "repro_transport_bytes_received_total",
                "repro_transport_connections 1",
                'repro_ingest_produced_records_total{topic="frames"} 64',
                'repro_ingest_flush_records_count{topic="frames"} 8',
                'repro_ingest_lag{topic="frames"} 0',
                'repro_delivery_enqueued_total{lane="probe"} 8',
                'repro_delivery_delivered_total{lane="probe"} 8',
                'repro_delivery_queue_depth{lane="probe"} 0',
                "repro_state_commits_total 8",
                "repro_state_commit_seconds_count 8",
                "repro_state_log_bytes",
                "repro_stream_batches_total 8",
                "repro_stream_records_total 64",
                "repro_stream_epoch 8",
                'repro_stream_lag{topic="frames"} 0',
        ):
            assert line in text, f"missing from /metrics: {line}"

        _, body = _get_json(obs.url + "/traces?last=100")
        spans = body["spans"]
        assert len(spans) == 8 and body["recorded"] == 8
        assert [s["epoch"] for s in spans] == list(range(1, 9))
        assert all(s["num_records"] == 8 for s in spans)
        assert set(spans[-1]["stages"]) == set(SPAN_STAGES)
        # "pump" is timed before the recorder exists (SpanRecorder.add);
        # every other stage runs inside the span, disjoint from the rest
        assert all(s["total_s"] >= sum(v for k, v in s["stages"].items()
                                       if k != "pump")
                   for s in spans)

        stats = client.stats()
        assert 0 < stats["requests_served"] < 64
        assert stats["frames_rejected"] == 0
        assert stats["connections"] >= 1

        status, health = _get_json(obs.url + "/health")
        assert status == 200
        assert health["status"] == "ok"
        assert health["topics"]["frames"]["lag"] == 0

        url = obs.url
        sc.close()                             # stops the endpoint too
        with pytest.raises(urllib.error.URLError):
            _get(url + "/health", timeout=2)
    finally:
        sc.close()
        client.close()
        server.stop()


def test_torch_obs_scrape_stream_rolls_spans_up(registry):
    """``scrape_stream`` reads the endpoint over HTTP and rolls the spans
    up per stage, shares summing to the spans' stage time."""
    broker = Broker()
    sc = StreamingContext(Context(), broker, max_records_per_partition=4)
    from repro_torch.data.sources import SyntheticRateSource
    sc.subscribe_source(SyntheticRateSource(rate=1e9, total=24), topic="t",
                        partitions=2)
    sc.foreach_batch(lambda rdd, info: rdd.collect())
    obs = sc.serve_observability()
    try:
        while sc.run_one_batch() is not None:
            pass
        scrape = scrape_stream(obs.url)
    finally:
        sc.close()
    assert len(scrape["spans"]) == 3 and scrape["epochs"] == (1, 3)
    assert scrape["records"] == 24 and scrape["batches"] == 3
    assert set(scrape["stages"]) == {"pump", "batch_fn", "sinks",
                                     "broker_commit"}
    stage_s = sum(st["seconds"] for st in scrape["stages"].values())
    assert sum(st["share"] for st in scrape["stages"].values()) == \
        pytest.approx(stage_s / scrape["span_total_s"])


# -- the same pipeline through both packages -------------------------------------

def _drive_pipeline(pkg: str, out: str) -> dict:
    """SyntheticRateSource (64 records, 2 partitions) -> batches of 16 ->
    MetricsSink + an NpzDirectorySink on a retry(2) lane, built from one
    package's classes into a fresh registry; the endpoint read over HTTP."""
    if pkg == "port":
        from repro_torch.core.bridge import TorchBridge
        from repro_torch.core.broker import Broker as B
        from repro_torch.core.pipeline import (NearRealTimePipeline,
                                               PipelineConfig)
        from repro_torch.data.delivery import SinkPolicy as Policy
        from repro_torch.data.metrics import MetricsRegistry as Registry
        from repro_torch.data.metrics import set_registry as swap
        from repro_torch.data.sinks import MetricsSink, NpzDirectorySink
        from repro_torch.data.sources import SyntheticRateSource
        bridge = TorchBridge(device=torch.device("cpu"))
    else:
        from repro.core import Broker as B
        from repro.core import NearRealTimePipeline, PipelineConfig
        from repro.data import MetricsSink, NpzDirectorySink
        from repro.data import SinkPolicy as Policy
        from repro.data import SyntheticRateSource
        from repro.data.metrics import MetricsRegistry as Registry
        from repro.data.metrics import set_registry as swap
        bridge = None

    def process(rdd, info, bridge):
        vals = sorted(rdd.collect())
        return [(f"batch-{info.index:06d}",
                 {"n": np.int64(len(vals)), "sum": np.int64(sum(vals))})]

    prev = swap(Registry())
    try:
        pipeline = NearRealTimePipeline(
            B(), PipelineConfig(batch_interval=0.01,
                                max_records_per_partition=8,
                                source_partitions=2),
            process, bridge=bridge,
            sinks=[MetricsSink(), (NpzDirectorySink(out),
                                   Policy.retry(2))])
        pipeline.subscribe_source(SyntheticRateSource(rate=1e9, total=64),
                                  topic="t")
    finally:
        swap(prev)
    obs = pipeline.serve_observability()
    try:
        pipeline.run_until_drained(idle_timeout=0.05)
        assert pipeline.streaming.delivery.drain(timeout=10)
        with urllib.request.urlopen(obs.url + "/metrics.json",
                                    timeout=10) as r:
            snap = json.load(r)
        with urllib.request.urlopen(obs.url + "/traces?last=100",
                                    timeout=10) as r:
            spans = json.load(r)["spans"]
    finally:
        pipeline.close()
    return {"snap": snap, "spans": spans,
            "batches": pipeline.report.batches}


@pytest.fixture(scope="module")
def both_pipelines(tmp_path_factory):
    locktrace.enable()
    try:
        return {pkg: _drive_pipeline(pkg, str(tmp_path_factory.mktemp(pkg)))
                for pkg in ("port", "reference")}
    finally:
        locktrace.disable()


def test_torch_obs_same_pipeline_same_metric_identities(both_pipelines):
    ids = {pkg: {(m["name"], tuple(sorted(m["labels"].items())), m["kind"])
                 for m in res["snap"]["metrics"]}
           for pkg, res in both_pipelines.items()}
    assert ids["port"] == ids["reference"]
    names = {n for n, _, _ in ids["port"]}
    assert {"broker_produce_records_total", "stream_records_total",
            "delivery_delivered_total", "stream_lag"} <= names


def test_torch_obs_same_pipeline_same_counter_values(both_pipelines):
    values = {pkg: {(m["name"], tuple(sorted(m["labels"].items()))):
                    m["value"] for m in res["snap"]["metrics"]
                    if m["kind"] == "counter"}
              for pkg, res in both_pipelines.items()}
    assert values["port"] == values["reference"]
    port = values["port"]
    assert port[("stream_records_total", ())] == 64
    assert port[("stream_batches_total", ())] == 4
    assert port[("delivery_delivered_total",
                 (("lane", "NpzDirectorySink"),))] == 4


def test_torch_obs_same_pipeline_same_span_stages(both_pipelines):
    stages = {pkg: [sorted(s["stages"]) for s in res["spans"]]
              for pkg, res in both_pipelines.items()}
    assert stages["port"] == stages["reference"]
    port = both_pipelines["port"]
    assert len(port["spans"]) == port["batches"] == 4
    assert [s["epoch"] for s in port["spans"]] == [1, 2, 3, 4]
    assert [s["num_records"] for s in port["spans"]] == [16] * 4
