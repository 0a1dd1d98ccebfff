"""The port's Spark layer on the CPU: RDD transformations and actions,
lineage fault tolerance and speculation (counterparts of tests/test_rdd.py),
the same RDD program and injected failures through both packages, the
scheduler's pool threads, the kernel library's first use from several
threads, the stream's inline and background loops and the pipeline's
``run`` (the counterpart of tests/test_apps.py's end-to-end pipeline), and
the §IV stream losing partitions and a straggler on purpose.

Every test runs with the port's lock tracing on and asserts afterwards that
the locks it took were acquired in no cyclic order. A test whose scheduler
abandons a straggler joins the straggler's thread before it ends, so no
thread of one test is counted by the next.
"""
import threading
import time
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import rdd as jax_rdd
from repro_torch.apps.tomo.stream import parse_args, run_stream
from repro_torch.core import (Broker, Context, FailureInjector,
                              NearRealTimePipeline, PartitionLostError,
                              PipelineConfig, StreamingContext, TaskScheduler)
from repro_torch.core import rdd as port_rdd
from repro_torch.core.bridge import TorchBridge
from repro_torch.data import locktrace
from repro_torch.kernels import _build

CPU = torch.device("cpu")


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


def _join_new_threads(before: set, timeout: float = 30.0) -> None:
    """Wait for the threads started since ``before`` (an abandoned
    straggler's pool thread), and fail if one is still alive."""
    deadline = time.monotonic() + timeout
    for t in set(threading.enumerate()) - before:
        if t.name.startswith("ThreadPoolExecutor"):
            t.join(max(0.0, deadline - time.monotonic()))
            assert not t.is_alive(), t.name


# -- transformations and actions (tests/test_rdd.py) ------------------------------
def test_torch_map_filter_collect():
    ctx = Context()
    assert isinstance(ctx.scheduler, TaskScheduler)
    assert ctx.scheduler.num_executors == 4      # threaded, as the reference
    rdd = ctx.parallelize(range(100), 7)
    assert rdd.map(lambda x: x * 2).collect() == [2 * x for x in range(100)]
    assert rdd.filter(lambda x: x % 3 == 0).collect() == \
        [x for x in range(100) if x % 3 == 0]
    assert rdd.count() == 100
    assert rdd.take(5) == [0, 1, 2, 3, 4]


def test_torch_union_preserves_partitions():
    ctx = Context()
    a = ctx.parallelize(range(10), 2)
    b = ctx.parallelize(range(10, 30), 3)
    u = a.union(b)
    assert u.num_partitions == 5
    assert sorted(u.collect()) == list(range(30))
    assert ctx.union([a, b]).collect() == list(range(30))
    assert {r.id for r in u.lineage()} == {a.id, b.id, u.id}


def test_torch_repartition_is_wide():
    ctx = Context()
    rdd = ctx.parallelize(range(20), 4).repartition(3)
    assert rdd.num_partitions == 3
    assert sorted(rdd.collect()) == list(range(20))
    assert len(rdd.lineage()) == 2


def test_torch_zip_partitions():
    ctx = Context()
    a = ctx.from_partitions([np.arange(3), np.arange(3, 6)])
    b = ctx.from_partitions([np.ones(3), np.ones(3)])
    z = a.zip_partitions(b, lambda x, y: x + y)
    got = z.collect_partitions()
    np.testing.assert_array_equal(got[0], [1, 2, 3])
    np.testing.assert_array_equal(got[1], [4, 5, 6])
    with pytest.raises(ValueError, match="equal partition counts"):
        a.zip_partitions(ctx.from_partitions([1]), lambda x, y: x)


def test_torch_reduce():
    ctx = Context()
    assert ctx.parallelize(range(10), 3).reduce(lambda a, b: a + b) == 45
    with pytest.raises(ValueError, match="empty"):
        ctx.parallelize([], 2).reduce(lambda a, b: a + b)


def _check_partitioning_preserves_data(data, nparts):
    """Any partitioning of any data collects back to the original list."""
    ctx = Context()
    rdd = ctx.parallelize(data, min(nparts, len(data)))
    assert rdd.collect() == data
    assert rdd.map(lambda x: x + 1).collect() == [x + 1 for x in data]


def test_torch_partitioning_preserves_data_smoke():
    rng = np.random.default_rng(3)
    for n, nparts in ((1, 1), (7, 3), (60, 8), (13, 8)):
        _check_partitioning_preserves_data(
            rng.integers(-100, 100, n).tolist(), nparts)


@given(st.lists(st.integers(-100, 100), min_size=1, max_size=60),
       st.integers(1, 8))
@settings(max_examples=25, deadline=None)
def test_torch_property_partitioning_preserves_data(data, nparts):
    _check_partitioning_preserves_data(data, nparts)


# -- lineage fault tolerance and speculation --------------------------------------
def test_torch_lineage_recompute_on_injected_failure():
    """A partition that fails twice is recomputed from lineage and the job
    still returns the right answer (the RDD resilience contract)."""
    inj = FailureInjector(fail={1: 2})
    ctx = Context(scheduler=TaskScheduler(num_executors=2, max_failures=4,
                                          failure_injector=inj))
    rdd = ctx.parallelize(range(30), 3).map(lambda x: x * x)
    assert rdd.collect() == [x * x for x in range(30)]
    assert ctx.scheduler.metrics["retries"] == 2
    assert ctx.scheduler.metrics["tasks"] == 5


def test_torch_unrecoverable_failure_raises():
    inj = FailureInjector(fail={0: 99})
    ctx = Context(scheduler=TaskScheduler(num_executors=2, max_failures=2,
                                          failure_injector=inj))
    with pytest.raises(RuntimeError, match="failed 3 times") as err:
        ctx.parallelize(range(4), 2).collect()
    assert isinstance(err.value.__cause__, PartitionLostError)


def test_torch_cached_partition_loss_recomputes():
    ctx = Context()
    calls = []
    base = ctx.parallelize(range(10), 2)
    traced = base.map_partitions_with_index(
        lambda i, part: (calls.append(i), part)[1]).cache()
    traced.collect()
    assert sorted(calls) == [0, 1]
    traced.collect()
    assert sorted(calls) == [0, 1]         # both partitions from the cache
    traced.unpersist_partition(1)          # a node's loss
    traced.collect()
    assert sorted(calls) == [0, 1, 1]      # only partition 1 recomputed


def test_torch_speculative_execution_beats_straggler():
    before = set(threading.enumerate())
    inj = FailureInjector(slow={0: 1.2})
    sched = TaskScheduler(num_executors=4, speculation=True,
                          speculation_multiplier=3.0,
                          speculation_quantile=0.25,
                          failure_injector=inj)
    ctx = Context(scheduler=sched)
    t0 = time.monotonic()
    out = ctx.parallelize(range(40), 8).map(lambda x: x + 1).collect()
    dt = time.monotonic() - t0
    assert out == [x + 1 for x in range(40)]
    assert sched.metrics["speculative"] >= 1
    assert sched.metrics["speculative_wins"] >= 1
    assert dt < 1.1     # the speculative copy finished before the straggler
    _join_new_threads(before)


# -- both packages ----------------------------------------------------------------
def _program(mod):
    """One RDD program through ``mod`` (either package's ``rdd`` module):
    narrow and wide dependencies, a union, a zip and a cached partition
    lost, with partitions 1 and 3 failing on their first attempts."""
    inj = mod.FailureInjector(fail={1: 2, 3: 1})
    sched = mod.TaskScheduler(num_executors=3, max_failures=4,
                              speculation=False, failure_injector=inj)
    ctx = mod.Context(scheduler=sched)
    base = ctx.parallelize(range(50), 5)
    squares = base.map(lambda x: x * x).filter(lambda x: x % 3 != 0).cache()
    wide = squares.repartition(4)
    both = wide.union(ctx.parallelize(range(100, 108), 2))
    zipped = both.zip_partitions(both.map(lambda x: -x),
                                 lambda a, b: [x + 2 * y for x, y in
                                               zip(a, b)])
    first = zipped.collect()
    squares.unpersist_partition(2)
    second = [zipped.count(), both.reduce(lambda a, b: a + b),
              squares.take(7), [len(r.lineage()) for r in (wide, zipped)]]
    return first, second, dict(sched.metrics)


def test_torch_rdd_program_and_failures_match_the_reference():
    before = set(threading.enumerate())
    got = _program(port_rdd)
    want = _program(jax_rdd)
    _join_new_threads(before)      # the reference leaves its pools' threads
    assert got == want
    assert got[2]["retries"] == 3 and got[2]["speculative"] == 0


# -- the scheduler's threads ------------------------------------------------------
@pytest.mark.parametrize("fail", [{}, {2: 1}])
def test_torch_run_with_nothing_running_leaves_no_pool_thread(fail):
    """With no straggler left running, ``run`` joins its idle pool threads
    before it returns (the reference leaves them to exit on their own),
    retries included."""
    before = threading.active_count()
    ctx = Context(scheduler=TaskScheduler(
        num_executors=4, failure_injector=FailureInjector(fail=fail)))
    for _ in range(20):
        assert ctx.parallelize(range(40), 8).map(
            lambda x: x + 1).collect() == list(range(1, 41))
        assert threading.active_count() == before
    assert ctx.scheduler.metrics["retries"] == (1 if fail else 0)


def test_torch_load_library_first_use_from_four_threads_links_once(
        tmp_path, monkeypatch):
    """Four threads reaching the kernels' first use together: one builds
    (one nvcc a source, one link) and loads, the others wait and get the
    same library."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.cu").write_text("// a")
    calls = tmp_path / "calls"
    script = tmp_path / "nvcc"
    # record the arguments, take a while, then write the -o target
    script.write_text(f'#!/bin/sh\necho "$@" >> {calls}\nsleep 0.2\n'
                      'while [ "$1" != "-o" ]; do shift; done\n'
                      'echo lib > "$2"\n')
    script.chmod(0o755)
    build = _build.build
    monkeypatch.setattr(_build, "build", lambda: build(
        src, tmp_path / "build", nvcc=str(script)))
    loaded = []

    def fake_cdll(path):
        loaded.append(path)
        return types.SimpleNamespace(**{
            name: types.SimpleNamespace() for name in _build.SIGNATURES})

    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(_build, "_library", None)
    barrier = threading.Barrier(4)
    got = []

    def first_use():
        barrier.wait(timeout=10)
        got.append(_build.load_library())

    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(got) == 4 and all(lib is got[0] for lib in got)
    assert loaded == [str(tmp_path / "build" / _build.LIB_NAME)]
    lines = calls.read_text().splitlines()
    assert len(lines) == 2 and sum("-shared" in c for c in lines) == 1
    assert got[0].art_sweep_csr_launch.restype is _build.ctypes.c_int


def test_torch_build_from_two_threads_at_once_gives_a_whole_library(
        tmp_path):
    """Two threads of one process building together each link to a temp
    file of their own, so both finish and the library is whole."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.cu").write_text("// a")
    script = tmp_path / "nvcc"
    # the -o target written first, then a while: both links have written
    # before either moves its temp file into place
    script.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                      'echo lib > "$2"\nsleep 0.3\n')
    script.chmod(0o755)
    out, errors = [], []

    def builder():
        try:
            out.append(_build.build(src, tmp_path / "build",
                                    nvcc=str(script)))
        except Exception as exc:       # reported by the assert below
            errors.append(exc)

    threads = [threading.Thread(target=builder) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert errors == [] and len(out) == 2
    assert out[0].read_text() == "lib\n"
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [_build.LIB_NAME, _build.LIB_NAME + ".sha256", _build.LOG_NAME])


# -- the stream's loops and the pipeline (tests/test_apps.py) -----------------------
@pytest.mark.parametrize("drive", ["run", "run_until_drained"])
def test_torch_near_realtime_pipeline_end_to_end(drive):
    """Producer thread -> broker -> micro-batches -> process -> report."""
    broker = Broker()
    broker.create_topic("frames", partitions=2)
    done = threading.Event()

    def producer():
        for i in range(40):
            broker.produce("frames", float(i), partition=i % 2)
        done.set()

    sums = []

    def process(rdd, info, bridge):
        vals = rdd.collect()
        sums.append(sum(vals))
        return sums[-1]

    pipe = NearRealTimePipeline(
        broker, PipelineConfig(topics=["frames"], batch_interval=0.02,
                               max_records_per_partition=5),
        process, bridge=TorchBridge(device=CPU))
    threading.Thread(target=producer, daemon=True).start()
    if drive == "run":
        report = pipe.run(max_batches=100, wait_for_data=1.0)
    else:
        report = pipe.run_until_drained(lambda: done.is_set())
    assert report.records == 40
    assert sum(sums) == sum(range(40))
    assert report.batches >= 4
    assert report.mean_latency < 0.5
    assert report.mean_latency <= report.max_latency
    assert report.keeps_up(report.max_latency)
    assert not report.keeps_up(report.max_latency / 2)


def test_torch_run_batches_waits_for_data():
    broker = Broker()
    broker.create_topic("t", 1)
    sc = StreamingContext(Context(), broker, batch_interval=0.01)
    sc.subscribe(["t"])
    sc.foreach_batch(lambda rdd, info: rdd.collect())
    assert sc.run_batches(5) == []                   # no data, no wait
    threading.Timer(0.2, broker.produce, ("t", 1)).start()
    infos = sc.run_batches(5, wait_for_data=2.0)
    assert [i.result for i in infos] == [[1]]


def test_torch_streaming_context_background_loop_start_stop():
    broker = Broker()
    broker.create_topic("t", 1)
    sc = StreamingContext(Context(), broker, batch_interval=0.01,
                          max_records_per_partition=4)
    sc.subscribe(["t"])
    seen = []
    sc.foreach_batch(lambda rdd, info: seen.extend(rdd.collect()))
    sc.start()
    thread = sc._thread
    for i in range(20):
        broker.produce("t", i)
    deadline = time.monotonic() + 10
    while len(seen) < 20 and time.monotonic() < deadline:
        time.sleep(0.01)
    sc.stop()
    assert not thread.is_alive() and sc._thread is None
    assert seen == list(range(20))
    assert len(sc.history) >= 5                  # 4 records a batch at most
    broker.produce("t", 99)
    time.sleep(0.1)
    assert 99 not in seen                        # no batch after stop()
    sc.start()                                   # close() stops the loop
    thread = sc._thread
    deadline = time.monotonic() + 10
    while 99 not in seen and time.monotonic() < deadline:
        time.sleep(0.01)
    sc.close()
    assert not thread.is_alive() and sc._thread is None
    assert seen == list(range(20)) + [99]


# -- the §IV stream losing partitions -------------------------------------------------
def test_torch_tomo_stream_replays_lineage_and_outruns_a_straggler(tmp_path):
    """The §IV stream with partition 0 lost on its first attempt (the first
    batch's broker read, replayed from its offsets), partition 1 lost once
    (an ART partition) and partition 2 a straggler in every batch: the same
    volume as a clean run, two retries, and a speculative copy winning in
    each of the four batches."""
    before = set(threading.enumerate())
    argv = ["--nray", "16", "--angles", "9", "--nslice", "16",
            "--partitions", "4"]
    clean = run_stream(parse_args(argv + ["--out", str(tmp_path / "a")]),
                       device=CPU)
    assert clean["scheduler_metrics"]["retries"] == 0
    sched = TaskScheduler(num_executors=4, speculation=True,
                          failure_injector=FailureInjector(
                              fail={0: 1, 1: 1}, slow={2: 1.0}))
    hurt = run_stream(parse_args(argv + ["--out", str(tmp_path / "b")]),
                      device=CPU, scheduler=sched)
    np.testing.assert_array_equal(hurt["volume"], clean["volume"])
    assert hurt["residual"] == clean["residual"]
    assert hurt["sink_keys"] == clean["sink_keys"]
    m = hurt["scheduler_metrics"]
    assert m["retries"] == 2
    assert m["speculative"] >= 4 and m["speculative_wins"] >= 4
    assert hurt["partitions"] == clean["partitions"] == 16
    _join_new_threads(before)
