"""The port's sources and ingest runner on the CPU: the counterparts of
tests/test_data_sources.py — replay determinism, seek, TopicSource, the
block/drop/sample bounds, the thread and rate limit, ``ingest_all``, the
zero-timeout inline run — the lag of a consumer group, the same sources
pumped through the JAX package's runner and the port's, which must leave the
same records in the same partitions with the same accounting, and the
remote-ingest entry point (a spawned detector producer over the socket
transport) on the CPU against numpy statistics of the JAX package's frames
of the same scan.

Every test runs with the port's lock tracing on and asserts afterwards that
the locks it took were acquired in no cyclic order.
"""
import json
import os
import time

import numpy as np
import pytest

from repro.core import Broker as JaxBroker
from repro.core import Context as JaxContext
from repro.core import OffsetRange as JaxOffsetRange
from repro.core import StreamingContext as JaxStreamingContext
from repro.data import FileReplaySource as JaxFileReplaySource
from repro.data import IngestConfig as JaxIngestConfig
from repro.data import IngestRunner as JaxIngestRunner
from repro.data import SyntheticRateSource as JaxSyntheticRateSource
from repro_torch.core.broker import Broker, OffsetRange
from repro_torch.core.dstream import StreamingContext
from repro_torch.core.rdd import Context
from repro_torch.data import locktrace
from repro_torch.data.groups import StaleGenerationError
from repro_torch.data.ingest import IngestConfig, IngestRunner, ingest_all
from repro_torch.data.sources import (DetectorSource, FileReplaySource,
                                      ProjectionSource, ReplayableSource,
                                      Source, SyntheticRateSource,
                                      TopicSource, save_npz_capture)


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


# -- replay determinism (tests/test_data_sources.py) -----------------------------

def test_torch_npz_replay_is_deterministic(tmp_path):
    path = str(tmp_path / "capture.npz")
    frames = [(f"frame-{i}", np.full((4, 4), i, np.float32)) for i in range(9)]
    save_npz_capture(path, frames)
    a = FileReplaySource(path)
    b = FileReplaySource(path)
    ra, rb = a.poll(100), b.poll(100)
    assert [k for k, _ in ra] == [k for k, _ in rb]
    assert len(ra) == 9 and a.exhausted
    for i, (key, val) in enumerate(ra):
        assert key.decode().endswith(f"frame-{i}")
        np.testing.assert_array_equal(val, frames[i][1])


def test_torch_jsonl_replay_preserves_file_order(tmp_path):
    path = str(tmp_path / "events.jsonl")
    events = [{"i": i, "v": i * i} for i in range(7)]
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")
    src = FileReplaySource(path)
    assert [v for _, v in src.poll(100)] == events
    with pytest.raises(ValueError, match="unsupported"):
        FileReplaySource(str(tmp_path / "capture.csv"))


def test_torch_seek_replays_same_records(tmp_path):
    path = str(tmp_path / "c.npz")
    save_npz_capture(path, [(f"x{i}", np.arange(i + 1)) for i in range(6)])
    src = FileReplaySource(path)
    assert isinstance(src, ReplayableSource) and isinstance(src, Source)
    first = src.poll(4)
    src.seek(0)
    again = src.poll(4)
    assert [k for k, _ in first] == [k for k, _ in again]
    src.seek(5)
    assert src.position == 5 and len(src.poll(10)) == 1
    with pytest.raises(ValueError):
        src.seek(99)


def test_torch_detector_and_projection_sources_match_apps():
    """The port's detector emits the JAX package's frames of the same scan
    (``simulate`` on the CPU, within round-off) and the tilt series the same
    slices."""
    from repro.apps.ptycho.sim import simulate as jax_simulate
    from repro_torch.apps.ptycho.sim import simulate

    problem = simulate(64, 16, 12, device="cpu")
    det = DetectorSource(problem, max_frames=10)
    recs = det.poll(100)
    assert [v for _, v in recs] == list(range(10)) and det.exhausted

    det2 = DetectorSource(problem, max_frames=3, emit_frames=True)
    (key, (idx, frame)), = det2.poll(1)
    assert key == b"frame-000000" and idx == 0
    ref = np.asarray(jax_simulate(64, 16, 12).magnitudes[0])
    np.testing.assert_allclose(frame, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))

    sino = np.arange(20, dtype=np.float32).reshape(5, 4)
    proj = ProjectionSource(sino)
    vals = [v for _, v in proj.poll(100)]
    assert [i for i, _ in vals] == list(range(5))
    np.testing.assert_array_equal(vals[3][1], sino[3])


# -- seek/resume after restart via StreamProgress --------------------------------

def test_torch_source_resume_after_restart(tmp_path):
    ckpt = str(tmp_path / "progress.json")
    broker = Broker()
    src = SyntheticRateSource(rate=1e9, total=20)
    sc = StreamingContext(Context(), broker, max_records_per_partition=4,
                          checkpoint_path=ckpt)
    sc.subscribe_source(src, topic="t")
    got: list[int] = []
    sc.foreach_batch(lambda rdd, info: got.extend(rdd.collect()))
    sc.run_one_batch()
    sc.run_one_batch()
    assert got == list(range(8))

    src2 = SyntheticRateSource(rate=1e9, total=20)
    sc2 = StreamingContext(Context(), broker, max_records_per_partition=4,
                           checkpoint_path=ckpt)
    sc2.subscribe_source(src2, topic="t")
    got2: list[int] = []
    sc2.foreach_batch(lambda rdd, info: got2.extend(rdd.collect()))
    while not (sc2.sources_exhausted and sc2.lag("t") == 0):
        sc2.run_one_batch()
    assert got2 == list(range(8, 20))
    assert sum(broker.end_offsets("t")) == 20


def test_torch_topic_source_seek_is_total_position():
    broker = Broker()
    broker.create_topic("src", 2)
    for i in range(10):
        broker.produce("src", i, partition=i % 2)   # p0: evens, p1: odds
    ts = TopicSource(broker, "src", stop_at_end=True)
    first = [v for _, v in ts.poll(100)]
    assert ts.position == 10
    ts.seek(7)                          # p0 fully drained (5) + 2 of p1
    rest = [v for _, v in ts.poll(100)]
    assert first[7:] == rest == [5, 7, 9]


def test_torch_subscribe_source_fills_all_partitions_per_batch():
    broker = Broker()
    sc = StreamingContext(Context(), broker, max_records_per_partition=8)
    sc.subscribe_source(SyntheticRateSource(rate=1e9, total=32),
                        topic="t", partitions=2)
    info = sc.run_one_batch()
    assert info.num_records == 16       # 8 per partition, both filled


def test_torch_topic_source_chains_stages():
    broker = Broker()
    broker.create_topic("stage1", 2)
    for i in range(10):
        broker.produce("stage1", i, partition=i % 2)
    src = TopicSource(broker, "stage1", stop_at_end=True)
    sc = StreamingContext(Context(), broker)
    sc.subscribe_source(src, topic="stage2")
    got: list[int] = []
    sc.foreach_batch(lambda rdd, info: got.extend(rdd.collect()))
    while not (sc.sources_exhausted and sc.lag("stage2") == 0):
        if sc.run_one_batch() is None:
            break
    assert sorted(got) == list(range(10))
    assert src.exhausted


# -- backpressure ----------------------------------------------------------------

def test_torch_backpressure_block_policy_bounds_lag():
    broker = Broker()
    sc = StreamingContext(Context(), broker, max_records_per_partition=8)
    runner = IngestRunner(broker, consumer=sc)
    fast = SyntheticRateSource(rate=1e9, total=300)
    cfg = IngestConfig(topic="t", policy="block", max_pending=16,
                       poll_batch=64)
    m = runner.add(fast, cfg)
    sc.subscribe(["t"])
    sc.foreach_batch(lambda rdd, info: len(rdd.collect()))
    seen_lags = []
    while not runner.done or sc.lag("t") > 0:
        runner.pump()
        seen_lags.append(sc.lag("t"))
        sc.run_one_batch()
    assert m.produced == 300 and m.dropped == 0
    assert max(seen_lags) <= cfg.max_pending       # block never overshoots
    assert m.max_observed_lag <= cfg.max_pending


def test_torch_backpressure_drop_policy_sheds_load():
    broker = Broker()
    sc = StreamingContext(Context(), broker, max_records_per_partition=4)
    runner = IngestRunner(broker, consumer=sc)
    fast = SyntheticRateSource(rate=1e9, total=400)
    cfg = IngestConfig(topic="t", policy="drop", max_pending=8, poll_batch=32)
    m = runner.add(fast, cfg)
    sc.subscribe(["t"])
    sc.foreach_batch(lambda rdd, info: len(rdd.collect()))
    while not runner.done or sc.lag("t") > 0:
        for _ in range(4):
            runner.pump()
        sc.run_one_batch()
    assert m.dropped > 0
    assert m.produced + m.dropped == 400
    assert m.max_observed_lag <= cfg.max_pending + cfg.poll_batch


def test_torch_backpressure_sample_policy_thins_stream():
    broker = Broker()
    sc = StreamingContext(Context(), broker, max_records_per_partition=4)
    runner = IngestRunner(broker, consumer=sc)
    fast = SyntheticRateSource(rate=1e9, total=400)
    cfg = IngestConfig(topic="t", policy="sample", max_pending=8,
                       poll_batch=32, sample_stride=4)
    m = runner.add(fast, cfg)
    sc.subscribe(["t"])
    got: list[int] = []
    sc.foreach_batch(lambda rdd, info: got.extend(rdd.collect()))
    while not runner.done or sc.lag("t") > 0:
        for _ in range(4):
            runner.pump()
        sc.run_one_batch()
    assert m.sampled_out > 0
    assert m.produced + m.sampled_out == 400
    assert sorted(got) == got                      # thinned but still ordered


def test_torch_ingest_runner_thread_and_rate_limit():
    broker = Broker()
    sc = StreamingContext(Context(), broker, max_records_per_partition=50)
    runner = IngestRunner(broker, consumer=sc)
    src = SyntheticRateSource(rate=1e9, total=120)
    m = runner.add(src, IngestConfig(topic="t", rate_limit=4000.0,
                                     poll_batch=16))
    sc.subscribe(["t"])
    got: list[int] = []
    sc.foreach_batch(lambda rdd, info: got.extend(rdd.collect()))
    runner.start()
    assert runner.join(timeout=30)
    runner.stop()
    while sc.lag("t") > 0:
        sc.run_one_batch()
    assert got == list(range(120)) and m.produced == 120
    assert m.throughput <= 4000.0 * 1.5 + 1e-9


def test_torch_ingest_all_convenience():
    broker = Broker()
    a = SyntheticRateSource(rate=1e9, total=5)
    b = SyntheticRateSource(rate=1e9, total=7, value_fn=lambda i: -i)
    ms = ingest_all(broker, [(a, IngestConfig(topic="ta")),
                             (b, IngestConfig(topic="tb"))])
    assert [m.produced for m in ms] == [5, 7]
    assert sum(broker.end_offsets("ta")) == 5
    assert sum(broker.end_offsets("tb")) == 7


def test_torch_run_inline_zero_timeout_gives_up_immediately():
    broker = Broker()
    runner = IngestRunner(broker)
    runner.add(SyntheticRateSource(rate=1e-6, total=3),
               IngestConfig(topic="t"))
    t0 = time.perf_counter()
    runner.run_inline(timeout=0)
    assert time.perf_counter() - t0 < 1.0
    assert sum(broker.end_offsets("t")) == 0


def test_torch_ingest_config_validation():
    with pytest.raises(ValueError, match="policy"):
        IngestConfig(topic="t", policy="spill")
    with pytest.raises(ValueError, match="flush_records"):
        IngestConfig(topic="t", flush_records=0)


# -- consumer groups ------------------------------------------------------------

def test_torch_consumer_group_lag_bounds_backpressure():
    """With ``consumer_group`` set, the runner measures lag against that
    group's broker-committed offsets: commits in the default group free no
    room, the group's own commits do."""
    broker = Broker()
    runner = IngestRunner(broker)
    m = runner.add(SyntheticRateSource(rate=1e9, total=40),
                   IngestConfig(topic="t", partitions=2, poll_batch=8,
                                max_pending=8, flush_records=1,
                                consumer_group="g1"))
    for _ in range(20):
        runner.pump()
    assert m.produced == 8 and broker.lag("t", group="g1") == 8
    assert runner.lag_snapshot() == {"t": 8}
    ends = broker.end_offsets("t")
    for p, end in enumerate(ends):
        broker.commit("t", p, end)                # the default group
    for _ in range(20):
        runner.pump()
    assert m.produced == 8                        # still blocked on g1
    for p, end in enumerate(ends):
        broker.commit("t", p, end, group="g1")
    assert runner.lag_snapshot() == {"t": 0}
    for _ in range(20):
        runner.pump()
    assert m.produced == 16 and m.max_observed_lag == 8
    assert sorted(broker.commit_groups("t")) == ["", "g1"]
    # a commit naming a generation is fenced by the group's coordinator
    gen = broker.join_group("g1", "c", ["t"])["generation"]
    with pytest.raises(StaleGenerationError):
        broker.commit("t", 0, 1, group="g1", consumer="c",
                      generation=gen + 1)
    assert broker.committed("t", group="g1") == ends


# -- the same sources through both packages ---------------------------------------

def _log(broker, offset_range, topic, parts):
    return [[(r.key, r.value, r.offset)
             for r in broker.read(offset_range(topic, p, 0, 1 << 20))]
            for p in range(parts)]


@pytest.mark.parametrize("policy", ["block", "drop", "sample"])
def test_torch_ingest_matches_the_reference(policy):
    """The same source and config, pumped with the same inline interleave
    against each package's broker and consumer, produce, shed and thin the
    same records into the same partitions."""
    def drive(broker_cls, ctx_cls, sc_cls, runner_cls, cfg_cls, src_cls):
        broker = broker_cls()
        sc = sc_cls(ctx_cls(), broker, max_records_per_partition=4)
        runner = runner_cls(broker, consumer=sc)
        m = runner.add(src_cls(rate=1e9, total=150,
                               value_fn=lambda i: (i, float(i) / 3)),
                       cfg_cls(topic="t", partitions=3, policy=policy,
                               max_pending=12, poll_batch=16,
                               flush_records=5))
        sc.subscribe(["t"])
        sc.foreach_batch(lambda rdd, info: len(rdd.collect()))
        while not runner.done or sc.lag("t") > 0:
            for _ in range(3):
                runner.pump()
            sc.run_one_batch()
        stats = {k: v for k, v in m.as_dict().items()
                 if k not in ("throughput_rec_per_s", "blocked_s")}
        return stats, broker

    port, port_broker = drive(Broker, Context, StreamingContext,
                              IngestRunner, IngestConfig,
                              SyntheticRateSource)
    ref, ref_broker = drive(JaxBroker, JaxContext, JaxStreamingContext,
                            JaxIngestRunner, JaxIngestConfig,
                            JaxSyntheticRateSource)
    assert port == ref
    assert (_log(port_broker, OffsetRange, "t", 3)
            == _log(ref_broker, JaxOffsetRange, "t", 3))
    assert port_broker.committed("t") == ref_broker.committed("t")


def test_torch_file_replay_matches_the_reference(tmp_path):
    """One capture, replayed by each package: the same keys and values in
    the same order, and after a seek the same tail."""
    path = save_npz_capture(str(tmp_path / "cap.npz"),
                            [(f"f{i}", np.random.default_rng(i)
                              .standard_normal((3, 3)).astype(np.float32))
                             for i in range(12)])
    port, ref = FileReplaySource(path), JaxFileReplaySource(path)
    a, b = port.poll(5), ref.poll(5)
    port.seek(9)
    ref.seek(9)
    a += port.poll(100)
    b += ref.poll(100)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (_, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x, y)


# -- the remote-ingest entry point ----------------------------------------------

def test_torch_run_remote_ingest_matches_numpy_on_the_jax_frames():
    """The remote-ingest entry point on the CPU at a small size, over TCP:
    every frame consumed once, on shm frames, nothing rejected or left in
    /dev/shm, and its photon count and peak equal to numpy's over the JAX
    package's ``simulate`` frames of the same scan."""
    from repro.apps.ptycho.sim import simulate as jax_simulate
    from repro_torch.apps.ptycho.remote_ingest import (parse_args,
                                                       run_remote_ingest)

    args = parse_args(["--frames", "48"])
    res = run_remote_ingest(args, device="cpu")
    assert res["frames"] == res["appended"] == 48
    assert res["frame_ids"] == list(range(48))
    mags = np.asarray(jax_simulate(args.obj_size, args.probe_size,
                                   step=8).magnitudes[:48], np.float64)
    assert res["photons"] == pytest.approx(float((mags ** 2).sum()),
                                           rel=1e-5)
    assert res["peak"] == pytest.approx(float(mags.max()), rel=1e-5)
    prod, served = res["producer"], res["server"]
    assert prod["produced"] == 48 and prod["shm_frames_sent"] >= 1
    assert prod["max_observed_lag"] <= args.max_pending + 16
    assert served["frames_rejected"] == 0
    assert served["shm_frames"] == prod["shm_frames_sent"]
    assert served["shm_segments"] == 0 and served["connections"] == 0
    assert res["realtime"]["records"] == 48
    assert not [f for f in os.listdir("/dev/shm")
                if f.startswith(f"reprotorchshm_{os.getpid()}_")]
