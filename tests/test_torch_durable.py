"""The port's lock tracing, message codec, durable log and offset checkpoint
on the CPU: counterparts of tests/test_locktrace.py, tests/test_durable_log.py
and the checkpoint tests of tests/test_broker_dstream.py, and the same
appends, window-state commits and checkpoints through the JAX package and the
port, which must leave byte-identical files that each side reads back.

Every test but the lock-tracing unit tests (which drive the switchboard
themselves) runs with the port's lock tracing on and asserts afterwards that
the locks it took were acquired in no cyclic order.
"""
import glob
import json
import multiprocessing as mp
import os
import queue
import signal
import socket
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.dstream import StreamProgress as JaxStreamProgress
from repro.data import durable_log as jax_durable_log
from repro.data import state as jax_state
from repro.data import transport as jax_transport
from repro_torch.core.broker import Broker, OffsetRange, PartitionLog
from repro_torch.core.dstream import StreamingContext, StreamProgress
from repro_torch.core.rdd import Context
from repro_torch.data import durable_log as port_durable_log
from repro_torch.data import locktrace
from repro_torch.data import state as port_state
from repro_torch.data import transport as port_transport
from repro_torch.data.durable_log import (DurableLogFactory,
                                          DurablePartitionLog,
                                          LogCorruptionError)
from repro_torch.data.locktrace import LockRegistry, TracingLock


@pytest.fixture(autouse=True)
def port_lock_order(request):
    """The port's counterpart of tests/conftest.py's harness: traced locks
    for the test, and no lock-order cycle at the end."""
    if request.node.name.startswith("test_torch_locktrace_"):
        yield
        return
    locktrace.enable()
    try:
        yield
    finally:
        report = locktrace.disable().report()
    assert not report.cycles, (
        "lock-order cycles detected (potential deadlock):\n"
        + report.describe())


# -- lock tracing (tests/test_locktrace.py) -----------------------------------
@pytest.fixture()
def registry():
    return LockRegistry()


def _run_threads(*targets):
    threads = [threading.Thread(target=t) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()


# -- cycle detection ---------------------------------------------------------

def test_torch_locktrace_ab_ba_interleaving_reports_cycle(registry):
    """Two threads nest A/B in opposite orders. The run itself never
    deadlocks (events serialize it) — the *graph* still has the cycle."""
    a = TracingLock("A", registry)
    b = TracingLock("B", registry)
    first_done = threading.Event()

    def ab():
        with a:
            with b:
                pass
        first_done.set()

    def ba():
        first_done.wait(10)
        with b:
            with a:
                pass

    _run_threads(ab, ba)
    rep = registry.report()
    assert rep.cycles == [["A", "B"]]
    assert ("A", "B") in rep.edges and ("B", "A") in rep.edges
    assert "cycle: A -> B -> A" in rep.describe()


def test_torch_locktrace_consistent_order_is_not_a_cycle(registry):
    a = TracingLock("A", registry)
    b = TracingLock("B", registry)

    def ab():
        for _ in range(50):
            with a:
                with b:
                    pass

    _run_threads(ab, ab, ab)
    rep = registry.report()
    assert rep.cycles == []
    assert set(rep.edges) == {("A", "B")}
    assert rep.locks == {"A", "B"}


def test_torch_locktrace_three_lock_cycle(registry):
    a = TracingLock("A", registry)
    b = TracingLock("B", registry)
    c = TracingLock("C", registry)
    for first, second in ((a, b), (b, c), (c, a)):
        with first:
            with second:
                pass
    assert registry.cycles() == [["A", "B", "C"]]


def test_torch_locktrace_edge_records_first_call_site(registry):
    a = TracingLock("A", registry)
    b = TracingLock("B", registry)
    with a:
        with b:
            pass
    site = registry.report().edges[("A", "B")]
    assert "test_torch_durable.py" in site


# -- reentrancy and release pairing ------------------------------------------

def test_torch_locktrace_rlock_reentrant_acquire_is_not_a_self_edge(registry):
    a = TracingLock("A", registry, reentrant=True)
    b = TracingLock("B", registry)
    with a:
        with a:          # reentrant: pushes, but must not edge A -> A
            with b:      # innermost holder is still A: edge A -> B
                pass
        assert a.locked()
    assert not a.locked()
    rep = registry.report()
    assert set(rep.edges) == {("A", "B")}
    assert rep.cycles == []


def test_torch_locktrace_release_pairs_by_identity_not_order(registry):
    # hand-over-hand: acquire A, acquire B, release A, release B
    a = TracingLock("A", registry)
    b = TracingLock("B", registry)
    a.acquire()
    b.acquire()
    a.release()
    with TracingLock("C", registry):  # holder should now be B, not A
        pass
    b.release()
    assert set(registry.report().edges) == {("A", "B"), ("B", "C")}


def test_torch_locktrace_failed_nonblocking_acquire_records_nothing(registry):
    a = TracingLock("A", registry)
    b = TracingLock("B", registry)

    def hold_then_signal(acquired, release):
        b.acquire()
        acquired.set()
        release.wait(10)
        b.release()

    acquired, release = threading.Event(), threading.Event()
    t = threading.Thread(target=hold_then_signal, args=(acquired, release))
    t.start()
    acquired.wait(10)
    with a:
        assert b.acquire(blocking=False) is False
    release.set()
    t.join(10)
    assert registry.report().edges == {}


def test_torch_locktrace_locked_probe_both_flavors(registry):
    for reentrant in (False, True):
        lk = TracingLock(f"L{reentrant}", registry, reentrant=reentrant)
        assert not lk.locked()
        with lk:
            assert lk.locked()
        assert not lk.locked()


# -- switchboard and hazard probes -------------------------------------------

def test_torch_locktrace_new_lock_plain_when_disabled():
    assert locktrace.active() is None
    lk, rlk = locktrace.new_lock("x"), locktrace.new_rlock("y")
    assert not isinstance(lk, TracingLock)
    assert not isinstance(rlk, TracingLock)
    with lk, rlk:
        pass


def test_torch_locktrace_new_lock_traced_when_enabled():
    with locktrace.tracing() as reg:
        lk = locktrace.new_lock("Demo._lock")
        rlk = locktrace.new_rlock("Demo._rlock")
        assert isinstance(lk, TracingLock) and not lk.reentrant
        assert isinstance(rlk, TracingLock) and rlk.reentrant
        assert locktrace.active() is reg
    assert locktrace.active() is None
    assert reg.report().locks == {"Demo._lock", "Demo._rlock"}


def test_torch_locktrace_enable_twice_raises():
    with locktrace.tracing():
        with pytest.raises(RuntimeError, match="already enabled"):
            locktrace.enable()
    with pytest.raises(RuntimeError, match="not enabled"):
        locktrace.disable()


def test_torch_locktrace_queue_get_hazard_only_while_holding():
    q = queue.Queue()
    q.put(1)
    q.put(2)
    with locktrace.tracing() as reg:
        lk = locktrace.new_lock("Holder._lock")
        q.get()                      # not holding anything: no hazard
        with lk:
            q.get()                  # blocking forever while holding
            q.put(3)
            q.get(timeout=1)         # bounded wait: fine
    hazards = reg.report().hazards
    assert len(hazards) == 1
    assert hazards[0].held == ("Holder._lock",)
    assert hazards[0].call == "queue.Queue.get(timeout=None)"
    assert "test_torch_durable.py" in hazards[0].site


def test_torch_locktrace_socket_recv_hazard():
    left, right = socket.socketpair()
    try:
        right.sendall(b"ping")
        with locktrace.tracing() as reg:
            lk = locktrace.new_lock("Conn._lock")
            with lk:
                left.settimeout(None)
                assert left.recv(4) == b"ping"
            right.sendall(b"pong")
            left.settimeout(5.0)
            with lk:
                assert left.recv(4) == b"pong"   # bounded: no hazard
        hazards = reg.report().hazards
        assert [h.call for h in hazards] == ["socket.recv(timeout=None)"]
    finally:
        left.close()
        right.close()


def test_torch_locktrace_disable_restores_patches():
    orig_get = queue.Queue.get
    orig_recv = socket.socket.recv
    with locktrace.tracing():
        assert queue.Queue.get is not orig_get
        assert socket.socket.recv is not orig_recv
    assert queue.Queue.get is orig_get
    assert socket.socket.recv is orig_recv


# -- integration: the production seams record real component locks -----------

def test_torch_locktrace_broker_seam_records_named_locks():
    with locktrace.tracing() as reg:
        broker = Broker()
        broker.create_topic("t", partitions=1)
        broker.produce("t", b"x")
    assert {"Broker._lock", "InMemoryPartitionLog._lock"} <= reg.report().locks
    assert reg.report().cycles == []


# -- the durable log (tests/test_durable_log.py) ------------------------------
def _seg_files(path):
    return sorted(glob.glob(os.path.join(path, "*.seg")))


# -- basics ------------------------------------------------------------------

def test_torch_durable_protocol_and_roundtrip(tmp_path):
    log = DurablePartitionLog(str(tmp_path / "p0"))
    assert isinstance(log, PartitionLog)
    assert log.end_offset() == 0
    assert log.append(b"k0", {"v": 0}, 1.5) == 0
    assert log.append(None, "plain", 2.5) == 1
    recs = log.read(0, 10)
    assert [(r.key, r.value, r.offset, r.timestamp) for r in recs] == \
        [(b"k0", {"v": 0}, 0, 1.5), (None, "plain", 1, 2.5)]
    assert log.read(1, 2)[0].value == "plain"
    log.close()


def test_torch_durable_reopen_recovers_records(tmp_path):
    path = str(tmp_path / "p0")
    with DurablePartitionLog(path) as log:
        for i in range(20):
            log.append(str(i).encode(), i, float(i))
    reopened = DurablePartitionLog(path)
    assert reopened.recovered_records == 20
    assert reopened.truncated_bytes == 0
    assert reopened.end_offset() == 20
    assert [r.value for r in reopened.read(0, 99)] == list(range(20))
    # appends continue the offset space after recovery
    assert reopened.append(None, "next", 0.0) == 20
    reopened.close()


def test_torch_durable_append_many_and_segment_roll(tmp_path):
    path = str(tmp_path / "p0")
    log = DurablePartitionLog(path, segment_bytes=512)
    offs = log.append_many([(None, f"value-{i:04d}") for i in range(40)], 1.0)
    assert offs == list(range(40))
    offs2 = log.append_many([(b"k", i) for i in range(40, 50)], 2.0)
    assert offs2 == list(range(40, 50))
    assert log.append_many([], 0.0) == []
    assert len(_seg_files(path)) > 1       # rolled past 512 bytes
    assert log.segments > 1
    vals = [r.value for r in log.read(0, 999)]
    assert vals == [f"value-{i:04d}" for i in range(40)] \
        + list(range(40, 50))              # reads span segments
    log.close()
    reopened = DurablePartitionLog(path, segment_bytes=512)
    assert reopened.end_offset() == 50
    assert [r.value for r in reopened.read(38, 42)] == \
        ["value-0038", "value-0039", 40, 41]
    reopened.close()


def test_torch_durable_ndarray_values_on_disk(tmp_path):
    """Values hit the segments in the transport's array-frame encoding and
    come back equal and writable."""
    path = str(tmp_path / "p0")
    frame = np.arange(64, dtype=np.float32).reshape(8, 8)
    with DurablePartitionLog(path) as log:
        log.append(b"f0", (0, frame), 0.0)
    with DurablePartitionLog(path) as log:
        (rec,) = log.read(0, 1)
        idx, got = rec.value
        np.testing.assert_array_equal(got, frame)
        assert got.flags.writeable


def test_torch_durable_oversized_record_refused_at_append(tmp_path, monkeypatch):
    """The recovery scan treats frames past MAX_FRAME_BYTES as corruption,
    so such a record must be refused at append time — committing it and
    destroying it (plus everything after) on the next open would be worse."""
    monkeypatch.setattr(port_durable_log, "MAX_FRAME_BYTES", 1024)
    with DurablePartitionLog(str(tmp_path / "p0")) as log:
        log.append(None, "fits", 0.0)
        with pytest.raises(ValueError, match="exceeds"):
            log.append(None, "x" * 4096, 0.0)
        with pytest.raises(ValueError, match="exceeds"):
            log.append_many([(None, "small"), (None, "y" * 4096)], 0.0)
        assert log.end_offset() == 1       # nothing partial committed
    monkeypatch.undo()
    reopened = DurablePartitionLog(str(tmp_path / "p0"))
    assert reopened.end_offset() == 1      # and reopen keeps everything
    assert reopened.truncated_bytes == 0
    reopened.close()


def test_torch_durable_fsync_policies(tmp_path):
    for policy in ("always", "interval", "never"):
        with DurablePartitionLog(str(tmp_path / policy), fsync=policy) as log:
            assert log.append_many([(None, i) for i in range(5)], 0.0) == \
                list(range(5))
    with pytest.raises(ValueError):
        DurablePartitionLog(str(tmp_path / "bad"), fsync="sometimes")


# -- recovery: torn tails and corruption ------------------------------------

def test_torch_durable_torn_tail_truncated_on_open(tmp_path):
    path = str(tmp_path / "p0")
    with DurablePartitionLog(path) as log:
        for i in range(5):
            log.append(None, f"rec-{i}", 0.0)
    (seg,) = _seg_files(path)
    clean_size = os.path.getsize(seg)
    with open(seg, "ab") as f:             # a produce died mid-write
        f.write(b"\x00\x00\x00\x30TORN-FRAME-ONLY-PARTIALLY-WRIT")
    log = DurablePartitionLog(path)
    assert log.truncated_bytes > 0
    assert os.path.getsize(seg) == clean_size
    assert log.end_offset() == 5
    assert [r.value for r in log.read(0, 99)] == [f"rec-{i}" for i in range(5)]
    assert log.append(None, "after-recovery", 0.0) == 5
    log.close()


def test_torch_durable_bit_flip_truncates_to_valid_prefix(tmp_path):
    """A flipped bit mid-file costs the suffix, never correctness: the scan
    keeps every record before the corruption and nothing after."""
    path = str(tmp_path / "p0")
    with DurablePartitionLog(path) as log:
        for i in range(10):
            log.append(str(i).encode(), {"i": i, "pad": "x" * 50}, 0.0)
    (seg,) = _seg_files(path)
    blob = bytearray(open(seg, "rb").read())
    blob[len(blob) // 2] ^= 0x10
    with open(seg, "wb") as f:
        f.write(blob)
    log = DurablePartitionLog(path)
    n = log.end_offset()
    assert 0 < n < 10                      # prefix survived, suffix cut
    assert log.truncated_bytes > 0
    for r in log.read(0, n):               # and the prefix is pristine
        assert r.value == {"i": r.offset, "pad": "x" * 50}
        assert r.key == str(r.offset).encode()
    log.close()


def test_torch_durable_corrupt_early_segment_orphans_later_ones(tmp_path):
    """Offsets must stay dense: segments after a corrupt one cannot rejoin
    the log; they are set aside as .orphan, not silently re-entered."""
    path = str(tmp_path / "p0")
    with DurablePartitionLog(path, segment_bytes=256) as log:
        for i in range(30):
            log.append(None, f"value-{i:04d}", 0.0)
    segs = _seg_files(path)
    assert len(segs) >= 3
    blob = bytearray(open(segs[0], "rb").read())
    blob[len(blob) // 2] ^= 0x01
    with open(segs[0], "wb") as f:
        f.write(blob)
    log = DurablePartitionLog(path, segment_bytes=256)
    n = log.end_offset()
    assert 0 < n < 30
    assert log.orphaned_segments == len(segs) - 1
    assert glob.glob(os.path.join(path, "*.orphan*"))
    assert [r.value for r in log.read(0, n)] == \
        [f"value-{i:04d}" for i in range(n)]
    # appends land after the recovered prefix and survive another reopen
    log.append(None, "post", 0.0)
    log.close()
    reopened = DurablePartitionLog(path, segment_bytes=256)
    assert reopened.end_offset() == n + 1
    assert reopened.read(n, n + 1)[0].value == "post"
    reopened.close()


def test_torch_durable_read_detects_corruption_under_live_log(tmp_path):
    """Corruption that lands *after* recovery accepted a record surfaces as
    LogCorruptionError on read — never a garbage record."""
    path = str(tmp_path / "p0")
    log = DurablePartitionLog(path)
    log.append(None, "x" * 200, 0.0)
    (seg,) = _seg_files(path)
    with open(seg, "r+b") as f:
        f.seek(40)
        f.write(b"\xff")
    with pytest.raises(LogCorruptionError):
        log.read(0, 1)
    log.close()


# -- factory + broker restart ------------------------------------------------

def test_torch_durable_factory_maps_topic_partition_dirs(tmp_path):
    factory = DurableLogFactory(str(tmp_path / "wal"))
    broker = Broker(log_factory=factory)
    broker.create_topic("alpha", 2)
    broker.create_topic("beta")
    broker.produce("alpha", 1, partition=1)
    assert factory.topics_on_disk() == {"alpha": 2, "beta": 1}
    assert os.path.isdir(os.path.join(str(tmp_path / "wal"), "alpha", "p0001"))
    for evil in ("", "..", "a/b", "a\x00b"):
        with pytest.raises(ValueError):
            factory(topic=evil, partition=0)


def test_torch_durable_broker_restart_replays_to_fresh_subscriber(tmp_path):
    """The acceptance path: produce through a durable broker, 'restart' it
    (new Broker over the same root), and a fresh StreamingContext subscriber
    replays every record."""
    root = str(tmp_path / "wal")
    frame = np.arange(16, dtype=np.float32)
    b1 = Broker(log_factory=DurableLogFactory(root))
    b1.create_topic("frames", 2)
    b1.produce_many("frames", [(f"k{i}".encode(), (i, frame * i))
                               for i in range(9)], partition=0)
    for i in range(9, 12):
        b1.produce("frames", (i, frame * i), partition=1)

    factory = DurableLogFactory(root)      # the restarted process
    b2 = Broker(log_factory=factory)
    assert factory.restore(b2) == ["frames"]
    assert b2.end_offsets("frames") == [9, 3]

    sc = StreamingContext(Context(), b2, max_records_per_partition=4)
    sc.subscribe(["frames"])
    seen = []
    sc.foreach_batch(lambda rdd, info: seen.extend(rdd.collect()))
    while sc.lag("frames") > 0:
        sc.run_one_batch()
    assert sorted(i for i, _ in seen) == list(range(12))
    for i, arr in seen:
        np.testing.assert_array_equal(arr, frame * i)


# -- crash: SIGKILL mid-produce ----------------------------------------------

def _crash_producer(root: str) -> None:
    """Child process: append records as fast as possible until killed."""
    broker = Broker(log_factory=DurableLogFactory(root, fsync="never"))
    broker.create_topic("t", 1)
    i = 0
    while True:
        broker.produce("t", {"i": i, "pad": "x" * 100},
                       key=str(i).encode(), timestamp=float(i))
        i += 1


def test_torch_durable_sigkill_mid_produce_keeps_committed_prefix(tmp_path):
    root = str(tmp_path / "wal")
    proc = mp.get_context("spawn").Process(target=_crash_producer,
                                           args=(root,), daemon=True)
    proc.start()
    seg = os.path.join(root, "t", "p0000", "00000000.seg")
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if os.path.exists(seg) and os.path.getsize(seg) > 20_000:
            break
        time.sleep(0.01)
    else:
        proc.kill()
        pytest.fail("producer never wrote enough data")
    os.kill(proc.pid, signal.SIGKILL)      # no goodbye, mid-produce
    proc.join(timeout=30)

    factory = DurableLogFactory(root)
    broker = Broker(log_factory=factory)
    assert factory.restore(broker) == ["t"]
    n = broker.end_offset("t", 0)
    assert n > 50                          # committed records survived...
    recs = broker.read(OffsetRange("t", 0, 0, n))
    assert [r.value["i"] for r in recs] == list(range(n))   # ...densely...
    for r in recs:                         # ...and uncorrupted
        assert r.key == str(r.value["i"]).encode()
        assert r.value["pad"] == "x" * 100
        assert r.timestamp == float(r.value["i"])


def test_torch_durable_reads_do_not_hold_the_appender_lock_across_disk_io(tmp_path):
    """read() snapshots the index under the lock but does its segment-file
    I/O outside it: a reader parked mid-pread must not stall appends (the
    old implementation held the appender RLock across every disk read)."""
    import threading

    log = DurablePartitionLog(str(tmp_path / "p0"))
    for i in range(10):
        log.append(b"k", i, 0.0)
    gate, entered = threading.Event(), threading.Event()
    orig = log._pread

    def parked_pread(fd, nbytes, pos):
        entered.set()
        assert gate.wait(10)
        return orig(fd, nbytes, pos)

    log._pread = parked_pread
    out = {}
    reader = threading.Thread(
        target=lambda: out.setdefault("recs", log.read(0, 10)))
    reader.start()
    try:
        assert entered.wait(10)
        # the reader is blocked inside its disk read; appends must proceed
        assert log.append(b"k", 99, 0.0) == 10
        assert log.append_many([(b"k", 100)], 0.0) == [11]
        assert log.end_offset() == 12
    finally:
        gate.set()
        reader.join(10)
    assert [r.value for r in out["recs"]] == list(range(10))
    log.close()


def test_torch_durable_directory_fsync_on_segment_create_and_orphan(tmp_path, monkeypatch):
    """The power-loss contract (module docstring): a new segment file and a
    recovery rename are only durable once the *directory* is fsynced, so
    both paths must fsync the partition dir — and fsync="never" skips it."""
    calls = []
    orig = DurablePartitionLog._fsync_dir
    monkeypatch.setattr(
        DurablePartitionLog, "_fsync_dir",
        lambda self: (calls.append(self.fsync), orig(self))[1])

    path = str(tmp_path / "p0")
    with DurablePartitionLog(path, segment_bytes=256) as log:
        for i in range(30):
            log.append(None, f"value-{i:04d}", 0.0)
    created = len(calls)
    assert created >= 3                    # one per segment file created
    # corrupt the first segment: recovery renames later ones to .orphan and
    # must fsync the directory for each rename
    segs = _seg_files(path)
    blob = bytearray(open(segs[0], "rb").read())
    blob[len(blob) // 2] ^= 0x01
    with open(segs[0], "wb") as f:
        f.write(blob)
    log = DurablePartitionLog(path, segment_bytes=256)
    assert log.orphaned_segments == len(segs) - 1
    assert len(calls) >= created + log.orphaned_segments
    log.close()

    # fsync="never" opts out of directory durability along with data fsync
    calls.clear()
    with DurablePartitionLog(str(tmp_path / "p1"), fsync="never") as log:
        log.append(None, "x", 0.0)
    assert calls == ["never"]              # invoked, but a no-op inside


# -- the offset checkpoint (tests/test_broker_dstream.py:200-260) -------------
def test_torch_checkpoint_serial_sink_runs_before_commit(tmp_path):
    """A raising serial sink leaves offsets, checkpoint file and broker-side
    progress untouched, and the batch replays to every sink."""
    path = str(tmp_path / "p.json")
    b = Broker()
    b.create_topic("t", 1)
    for i in range(4):
        b.produce("t", i)
    sc = StreamingContext(Context(), b, checkpoint_path=path)
    sc.subscribe(["t"])
    sc.foreach_batch(lambda rdd, info: rdd.collect())
    events = []
    sc.add_sink(lambda info: events.append(("sink", list(info.result))))

    armed = {"boom": True}

    def exploding(info):
        events.append(("boom", list(info.result)))
        if armed.pop("boom", False):
            raise RuntimeError("sink died")

    sc.add_sink(exploding)
    with pytest.raises(RuntimeError):
        sc.run_one_batch()
    assert sc.committed("t") == 0
    assert StreamProgress.load(path).offsets == {}
    assert b.committed("t") == [0]
    assert sc.history == []
    info = sc.run_one_batch()
    assert info.result == [0, 1, 2, 3]
    assert events == [("sink", [0, 1, 2, 3]), ("boom", [0, 1, 2, 3]),
                      ("sink", [0, 1, 2, 3]), ("boom", [0, 1, 2, 3])]
    assert StreamProgress.load(path).offsets == {"t": [4]}
    assert StreamProgress.load(path).epoch == 1


def test_torch_corrupt_checkpoint_degrades_to_empty(tmp_path):
    """A torn or garbage checkpoint falls back to empty progress (replay
    from 0) with a warning, never an unrecoverable restart."""
    path = str(tmp_path / "p.json")
    StreamProgress(offsets={"t": [5]}, epoch=3).save(path)
    blob = open(path, "rb").read()
    cases = {
        "truncated": blob[:len(blob) // 2],
        "garbage": b"\x00\xffnot json at all",
        "wrong-shape": b'{"offsets": 42}',
        "missing-key": b'{"epoch": 1}',
    }
    for name, payload in cases.items():
        with open(path, "wb") as f:
            f.write(payload)
        got = StreamProgress.load(path)
        assert got.offsets == {} and got.epoch == 0, name
    b = Broker()
    b.create_topic("t", 1)
    for i in range(3):
        b.produce("t", i)
    sc = StreamingContext(Context(), b, checkpoint_path=path)
    sc.subscribe(["t"])
    seen = []
    sc.foreach_batch(lambda rdd, info: seen.extend(rdd.collect()))
    sc.run_one_batch()
    assert seen == [0, 1, 2]


def test_torch_old_format_checkpoint_still_loads(tmp_path):
    path = str(tmp_path / "p.json")
    with open(path, "w") as f:
        json.dump({"offsets": {"t": [7]}}, f)   # pre-epoch format
    got = StreamProgress.load(path)
    assert got.offsets == {"t": [7]} and got.epoch == 0
    assert got.window_refs == {}


def test_torch_checkpoint_resumes_a_restarted_context(tmp_path):
    """A new context over the same checkpoint starts where the last one
    committed: nothing replayed, nothing skipped."""
    path = str(tmp_path / "p.json")
    b = Broker()
    b.create_topic("t", 2)
    for i in range(10):
        b.produce("t", i, partition=i % 2)
    seen = []

    def context():
        sc = StreamingContext(Context(), b, max_records_per_partition=2,
                              checkpoint_path=path)
        sc.subscribe(["t"])
        sc.foreach_batch(lambda rdd, info: seen.extend(rdd.collect()))
        return sc

    context().run_one_batch()
    assert sorted(seen) == [0, 1, 2, 3]
    sc = context()
    assert sc.committed("t") == 4
    while sc.run_one_batch() is not None:
        pass
    assert sorted(seen) == list(range(10))


# -- the message codec (repro/data/transport.py) -------------------------------
_MESSAGES = [
    (b"k", 7, 0.5),
    (None, "plain", 1.0),
    (b"frame-000003", (3, np.arange(12, dtype=np.float32).reshape(3, 4)), 2.0),
    ("tuple", [1, 2.5, {"a": (None, b"x")}], 3.0),
    (b"t", np.arange(6, dtype=np.int64)[::2], 4.0),   # non-contiguous
]


@pytest.mark.parametrize("msg", _MESSAGES, ids=range(len(_MESSAGES)))
def test_torch_codec_matches_reference_bytes(msg):
    """The port encodes every message to the reference's bytes, and each
    side decodes the other's."""
    port = b"".join(port_transport.encode_message(msg))
    ref = b"".join(jax_transport.encode_message(msg))
    assert port == ref
    for got in (port_transport.decode_message(bytearray(ref)),
                jax_transport.decode_message(bytearray(port))):
        assert repr(got) == repr(msg)


def test_torch_codec_refuses_what_the_allow_list_does_not_name():
    """A torch tensor (or any class off the list) never decodes: the log
    holds frame ids and keys, not device tensors."""
    payload = b"".join(port_transport.encode_message(torch.zeros(2)))
    with pytest.raises(port_transport.FrameError, match="refusing"):
        port_transport.decode_message(payload)
    with pytest.raises(port_transport.FrameError):
        port_transport.decode_message(b"")
    with pytest.raises(port_transport.FrameError, match="unknown"):
        port_transport.decode_message(b"Zjunk")


def test_torch_traced_seams_record_the_port_locks(tmp_path):
    """Under tracing, the broker, the durable log, the state store and the
    delivery runtime take named, traced locks."""
    from repro_torch.data.delivery import DeliveryRuntime
    reg = locktrace.active()
    broker = Broker(log_factory=DurableLogFactory(str(tmp_path / "wal")))
    broker.create_topic("t", 1)
    broker.produce("t", 1)
    store = port_state.DurableStateStore(str(tmp_path / "w"))
    store.commit(1, port_state.WindowState(buf=[(1, 0.0, 0)]))
    store.close()
    DeliveryRuntime(broker).close()
    assert {"Broker._lock", "DurablePartitionLog._lock",
            "DurableStateStore._lock", "DeliveryRuntime._failure_lock"} \
        <= reg.report().locks


# -- held against the JAX package: the same bytes on disk ---------------------
def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _appends(seed):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(40):
        kind = i % 4
        if kind == 0:
            value = int(rng.integers(0, 1 << 20))
        elif kind == 1:
            value = (i, rng.standard_normal((4, 4)).astype(np.float32))
        elif kind == 2:
            value = {"i": i, "pad": "x" * int(rng.integers(0, 60))}
        else:
            value = f"value-{i:04d}"
        key = None if i % 5 == 0 else f"frame-{i:06d}".encode()
        recs.append((key, value, float(i) / 4))
    return recs


def test_torch_durable_log_files_match_the_reference(tmp_path):
    """The same appends (fixed timestamps, segment rolls, single and batched)
    through the reference's DurablePartitionLog and the port's leave
    byte-identical segment files, and each side reads the other's log."""
    recs = _appends(0)
    logs = {}
    for name, mod in (("ref", jax_durable_log), ("port", port_durable_log)):
        with mod.DurablePartitionLog(str(tmp_path / name / "p0000"),
                                     segment_bytes=600) as log:
            for key, value, ts in recs[:20]:
                log.append(key, value, ts)
            for start in range(20, 40, 5):
                log.append_many([(k, v) for k, v, _ in recs[start:start + 5]],
                                float(start))
        logs[name] = _files(str(tmp_path / name))
    assert len(logs["ref"]) > 2                  # several segments
    assert logs["port"] == logs["ref"]
    want = [(k, v, ts) for k, v, ts in recs[:20]] + [
        (k, v, float(start)) for start in range(20, 40, 5)
        for k, v, _ in recs[start:start + 5]]
    for reader, written in ((port_durable_log, "ref"),
                            (jax_durable_log, "port")):
        with reader.DurablePartitionLog(
                str(tmp_path / written / "p0000"), segment_bytes=600) as log:
            got = [(r.key, r.value, r.timestamp) for r in log.read(0, 99)]
            assert log.recovered_records == 40
        assert repr(got) == repr(want)


def _commits(seed):
    """A seeded run of window-state commits: pushes, evictions, a window
    fired now and then, and one rollback-shaped change."""
    rng = np.random.default_rng(seed)
    buf, evicted, fired, out = [], 0, 0, []
    for epoch in range(1, 19):
        n = int(rng.integers(0, 4))
        buf = buf + [(int(rng.integers(0, 1000)), float(epoch), epoch)
                     for _ in range(n)]
        if len(buf) > 6:
            drop = len(buf) - 3
            buf, evicted, fired = buf[drop:], evicted + drop, fired + 1
        if epoch == 11:                   # counters go back: a snapshot
            buf, evicted, fired = buf[:1], max(0, evicted - 2), fired - 1
        out.append((epoch, list(buf), evicted, fired))
    return out


def test_torch_state_store_and_checkpoint_files_match_the_reference(
        tmp_path):
    """The same seeded commits, across several compactions, through the
    reference's DurableStateStore and StreamProgress and the port's: the
    files are byte-identical after every commit, and each side restores the
    other's state and checkpoint."""
    commits = _commits(1)
    stores = {"ref": jax_state.DurableStateStore(
                  str(tmp_path / "ref" / "w"), snapshot_every=3),
              "port": port_state.DurableStateStore(
                  str(tmp_path / "port" / "w"), snapshot_every=3)}
    states = {"ref": jax_state.WindowState, "port": port_state.WindowState}
    progress = {"ref": JaxStreamProgress, "port": StreamProgress}
    refs = {}
    for epoch, buf, evicted, fired in commits:
        for name, store in stores.items():
            refs[name] = store.commit(epoch, states[name](
                buf=list(buf), evicted=evicted, t0=0.0,
                windows_fired=fired))
            progress[name](offsets={"frames": [3 * epoch, epoch]},
                           epoch=epoch, window_refs={"window-0": refs[name]}
                           ).save(str(tmp_path / name / "ckpt.json"))
        assert refs["port"] == refs["ref"]
        assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "ref"))
    assert stores["port"].snapshots == stores["ref"].snapshots >= 3
    for store in stores.values():
        store.close()
    _, buf, evicted, fired = commits[-1]
    for reader, written in (("port", "ref"), ("ref", "port")):
        ckpt = progress[reader].load(str(tmp_path / written / "ckpt.json"))
        assert ckpt.offsets == {"frames": [3 * 18, 18]} and ckpt.epoch == 18
        store = (port_state if reader == "port" else jax_state) \
            .DurableStateStore(str(tmp_path / written / "w"))
        got = store.restore(ckpt.window_refs["window-0"])
        store.close()
        assert (got.buf, got.evicted, got.windows_fired) == (buf, evicted,
                                                             fired)
