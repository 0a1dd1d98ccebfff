"""The port's socket transport on the CPU: the counterparts of
tests/test_transport.py (framing, server/client parity, cross-process round
trips, reconnect, concurrency, torn-write rejection, shared-memory frames)
and of tests/test_broker_parity.py's contract matrix over the port's
backends; the wire between the packages, both ways (a reference client
against the port's server and the port's client against the reference's
server, over TCP and a Unix socket, with array and shared-memory frames);
the group and replication ops answered as the reference's server answers
them; and the repaired shm release order.

Every test runs with the port's lock tracing on and asserts afterwards that
the locks it took were acquired in no cyclic order.
"""
import multiprocessing as mp
import os
import socket
import struct
import threading
import time
import zlib

import pytest

# The test process has JAX's threads running; os.fork() under threads is
# what the RuntimeWarning warns about, so every subprocess here uses the
# spawn context and this marker turns any regression into a failure.
pytestmark = pytest.mark.filterwarnings(
    "error:os.fork\\(\\) was called:RuntimeWarning")

import numpy as np

from repro.core import Broker as JaxBroker
from repro.core import OffsetRange as JaxOffsetRange
from repro.data import transport as jax_transport
from repro_torch.core.broker import (Broker, InMemoryPartitionLog,
                                     OffsetRange, PartitionLog)
from repro_torch.core.dstream import StreamingContext
from repro_torch.core.rdd import Context
from repro_torch.data import locktrace
from repro_torch.data import transport as port_transport
from repro_torch.data.transport import (MAGIC, BrokerServer, FrameError,
                                        RemoteBroker, TransportError,
                                        parse_address, recv_frame, send_frame,
                                        serve_broker)


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


# -- framing -----------------------------------------------------------------

def _pair():
    a, b = socket.socketpair()
    a.settimeout(5)
    b.settimeout(5)
    return a, b


def test_torch_frame_roundtrip():
    a, b = _pair()
    for payload in (b"", b"x", os.urandom(70_000)):
        send_frame(a, payload)
        assert recv_frame(b) == payload
    a.close()
    assert recv_frame(b) is None          # clean EOF at a frame boundary
    b.close()


def test_torch_torn_frame_rejected():
    a, b = _pair()
    header = struct.pack(">2sII", MAGIC, 100, zlib.crc32(b"irrelevant"))
    a.sendall(header + b"only-16-bytes!!!")    # promises 100, delivers 16
    a.close()
    with pytest.raises(FrameError, match="torn frame"):
        recv_frame(b)
    b.close()


def test_torch_bad_magic_rejected():
    a, b = _pair()
    a.sendall(struct.pack(">2sII", b"ZZ", 4, 0) + b"data")
    with pytest.raises(FrameError, match="bad magic"):
        recv_frame(b)
    a.close(); b.close()


def test_torch_checksum_mismatch_rejected():
    a, b = _pair()
    payload = b"detector-frame-bytes"
    header = struct.pack(">2sII", MAGIC, len(payload),
                         zlib.crc32(payload) ^ 0xDEAD)
    a.sendall(header + payload)
    with pytest.raises(FrameError, match="checksum"):
        recv_frame(b)
    a.close(); b.close()


def test_torch_oversized_length_rejected_before_alloc():
    a, b = _pair()
    a.sendall(struct.pack(">2sII", MAGIC, 1 << 31, 0))
    with pytest.raises(FrameError, match="exceeds"):
        recv_frame(b)
    a.close(); b.close()


def test_torch_parse_address():
    assert parse_address("10.0.0.7:9092") == ("10.0.0.7", 9092)
    assert parse_address(":9092") == ("127.0.0.1", 9092)
    assert parse_address("/tmp/broker.sock") == "/tmp/broker.sock"


# -- PartitionLog protocol extraction ---------------------------------------

class ListBackedLog:
    """Minimal alternate PartitionLog: proves Broker only needs the protocol."""

    def __init__(self):
        self.rows = []
        self._lock = threading.Lock()

    def append(self, key, value, timestamp):
        with self._lock:
            from repro_torch.core.broker import Record
            self.rows.append(Record(key, value, len(self.rows), timestamp))
            return len(self.rows) - 1

    def read(self, start, until):
        with self._lock:
            return self.rows[start:min(until, len(self.rows))]

    def end_offset(self):
        with self._lock:
            return len(self.rows)


def test_torch_partition_log_protocol():
    assert isinstance(InMemoryPartitionLog(), PartitionLog)
    assert isinstance(ListBackedLog(), PartitionLog)


def test_torch_broker_over_custom_log_factory():
    b = Broker(log_factory=ListBackedLog)
    b.create_topic("t", 2)
    for i in range(6):
        b.produce("t", i, partition=i % 2)
    assert [r.value for r in b.read(OffsetRange("t", 0, 0, 9))] == [0, 2, 4]
    assert b.end_offsets("t") == [3, 3]


def test_torch_broker_commit_monotonic_and_lag():
    b = Broker()
    b.create_topic("t", 2)
    for i in range(10):
        b.produce("t", i, partition=i % 2)
    assert b.lag("t") == 10
    b.commit("t", 0, 4)
    b.commit("t", 0, 2)                   # replay never rewinds progress
    b.commit("t", 1, 5)
    assert b.committed("t") == [4, 5]
    assert b.lag("t") == 1
    with pytest.raises(KeyError):
        b.commit("nope", 0, 1)


# -- server/client parity ----------------------------------------------------

@pytest.fixture
def served(tmp_path):
    broker = Broker()
    server = serve_broker(broker, str(tmp_path / "broker.sock"))
    client = RemoteBroker(server.address, max_retries=2, retry_delay=0.01)
    yield broker, server, client
    client.close()
    server.stop()


def test_torch_remote_matches_local(served):
    broker, server, client = served
    assert client.ping()
    client.create_topic("t", 3)
    offs = [client.produce("t", {"i": i}, key=f"k{i}".encode(),
                           partition=i % 3) for i in range(9)]
    assert offs == [0, 0, 0, 1, 1, 1, 2, 2, 2]
    assert client.topics() == broker.topics() == ["t"]
    assert client.num_partitions("t") == 3
    assert client.end_offsets("t") == broker.end_offsets("t") == [3, 3, 3]
    assert client.end_offset("t", 1) == 3
    recs = client.read(OffsetRange("t", 1, 0, 10))
    assert [r.value for r in recs] == [{"i": 1}, {"i": 4}, {"i": 7}]
    assert [r.offset for r in recs] == [0, 1, 2]
    client.commit("t", 0, 3)
    assert broker.committed("t") == [3, 0, 0]
    assert client.lag("t") == broker.lag("t") == 6


def test_torch_remote_raises_broker_errors(served):
    _, _, client = served
    with pytest.raises(KeyError):
        client.end_offsets("missing-topic")
    client.create_topic("t")
    with pytest.raises(ValueError):
        client.create_topic("t")
    assert client.ping()                  # connection survives error frames


def test_torch_remote_numpy_payloads(served):
    np = pytest.importorskip("numpy")
    _, _, client = served
    client.create_topic("frames")
    frame = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
    client.produce("frames", (7, frame), key=b"frame-7")
    (rec,) = client.read(OffsetRange("frames", 0, 0, 1))
    idx, got = rec.value
    assert idx == 7 and got.dtype == np.float32
    np.testing.assert_array_equal(got, frame)


# -- cross-process round trip ------------------------------------------------

def _producer_main(address, n):
    from repro_torch.data.transport import RemoteBroker
    client = RemoteBroker(address)
    for i in range(n):
        client.produce("xp", i, key=f"p{i}".encode(), partition=i % 2)
    client.close()


def test_torch_append_read_across_processes(tmp_path):
    broker = Broker()
    broker.create_topic("xp", 2)
    server = serve_broker(broker, ("127.0.0.1", 0))
    try:
        proc = mp.get_context("spawn").Process(
            target=_producer_main, args=(server.address, 40))
        proc.start()
        proc.join(timeout=30)
        assert proc.exitcode == 0
        assert sum(broker.end_offsets("xp")) == 40
        evens = [r.value for r in broker.read(OffsetRange("xp", 0, 0, 99))]
        assert evens == list(range(0, 40, 2))   # per-partition total order
    finally:
        server.stop()


def test_torch_streaming_consumer_over_remote_broker(tmp_path):
    """The consumer side of the split: StreamingContext driven entirely
    through RemoteBroker, commits landing on the served broker."""
    broker = Broker()
    server = serve_broker(broker, str(tmp_path / "b.sock"))
    client = RemoteBroker(server.address)
    try:
        client.create_topic("t", 2)
        for i in range(12):
            client.produce("t", i, partition=i % 2)
        sc = StreamingContext(Context(), client, max_records_per_partition=4)
        sc.subscribe(["t"])
        seen = []
        sc.foreach_batch(lambda rdd, info: seen.extend(rdd.collect()))
        sc.run_batches(3)
        assert sorted(seen) == list(range(12))
        assert broker.committed("t") == [6, 6]   # pushed over the wire
        assert client.lag("t") == 0
    finally:
        client.close()
        server.stop()


# -- reconnect ---------------------------------------------------------------

def test_torch_client_reconnects_after_server_restart():
    broker = Broker()
    broker.create_topic("t")
    server = serve_broker(broker, ("127.0.0.1", 0))
    client = RemoteBroker(server.address, max_retries=6, retry_delay=0.05)
    assert client.produce("t", "before") == 0
    host, port = server.address
    server.stop()
    server2 = BrokerServer(broker, (host, port)).start()
    try:
        assert client.produce("t", "after") == 1      # transparent reconnect
        assert client.reconnects >= 1
        assert [r.value for r in broker.read(OffsetRange("t", 0, 0, 2))] == \
            ["before", "after"]
    finally:
        client.close()
        server2.stop()


def test_torch_retries_are_bounded():
    client = RemoteBroker(("127.0.0.1", 1), connect_timeout=0.2,
                          max_retries=1, retry_delay=0.01)
    with pytest.raises(TransportError, match="unreachable after 2 attempts"):
        client.ping()


# -- concurrency -------------------------------------------------------------

def test_torch_concurrent_producers_one_topic(tmp_path):
    broker = Broker()
    broker.create_topic("t", 1)
    server = serve_broker(broker, str(tmp_path / "b.sock"))
    n_producers, per_producer = 4, 50
    errors = []

    def producer(pid):
        try:
            client = RemoteBroker(server.address)
            for i in range(per_producer):
                client.produce("t", (pid, i), key=f"{pid}-{i}".encode())
            client.close()
        except Exception as e:            # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(p,))
               for p in range(n_producers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    server.stop()
    assert not errors
    recs = broker.read(OffsetRange("t", 0, 0, 10 ** 6))
    assert len(recs) == n_producers * per_producer
    assert [r.offset for r in recs] == list(range(len(recs)))  # dense log
    for p in range(n_producers):          # each producer's order preserved
        assert [v for pid, v in (r.value for r in recs) if pid == p] == \
            list(range(per_producer))


# -- torn writes against a live server --------------------------------------

def test_torch_server_rejects_garbage_and_survives(served):
    _, server, client = served
    client.create_topic("t")
    client.produce("t", 1)
    # a rogue/corrupt peer: valid header promising more bytes than sent
    rogue = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    rogue.connect(server.address)
    rogue.sendall(struct.pack(">2sII", MAGIC, 500, 0) + b"short")
    rogue.close()
    # and one speaking a different protocol entirely
    rogue2 = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    rogue2.connect(server.address)
    rogue2.sendall(b"GET / HTTP/1.1\r\n\r\n")
    rogue2.close()
    deadline = time.monotonic() + 5
    while server.frames_rejected < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert server.frames_rejected == 2
    assert client.produce("t", 2) == 1    # healthy clients unaffected
    assert client.end_offsets("t") == [2]


# -- hardening from review ---------------------------------------------------

def test_torch_wire_unpickler_refuses_dangerous_globals(served):
    """A well-formed frame whose pickle smuggles a callable must be refused
    before instantiation — the server answers with an error, runs nothing."""
    import pickle

    from repro_torch.data.transport import KIND_PICKLE, decode_message

    evil = KIND_PICKLE + pickle.dumps((os.system, ("echo pwned",)))
    with pytest.raises(FrameError, match="refusing to unpickle"):
        decode_message(evil)

    _, server, client = served
    rogue = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    rogue.settimeout(5)
    rogue.connect(server.address)
    send_frame(rogue, evil)
    resp = recv_frame(rogue)
    rogue.close()
    status, exc_name, message = decode_message(resp)
    assert status == "err" and "refusing to unpickle" in message
    assert client.ping()                  # server healthy, nothing executed


def test_torch_oversized_request_fails_fast_no_retries(served, monkeypatch):
    import repro_torch.data.transport as tr
    _, _, client = served
    client.create_topic("t")
    monkeypatch.setattr(tr, "MAX_FRAME_BYTES", 1024)
    with pytest.raises(FrameError, match="exceeds"):
        client.produce("t", b"x" * 4096)
    assert client.reconnects == 0         # rejected before any send/retry
    monkeypatch.undo()
    assert client.produce("t", b"small") == 0


def test_torch_commit_rejects_bad_partition_and_offset(served):
    broker, _, client = served
    client.create_topic("t", 2)
    client.produce("t", 1, partition=0)
    for bad in [("t", -1, 1), ("t", 2, 1), ("t", 0, -1), ("t", 0, 5)]:
        with pytest.raises(ValueError):
            client.commit(*bad)
    assert broker.committed("t") == [0, 0]   # nothing poisoned
    client.commit("t", 0, 1)
    assert broker.committed("t") == [1, 0]


# -- batched produce over the wire -------------------------------------------

def test_torch_ingest_batches_produce_over_remote(tmp_path):
    """IngestRunner's flush buffer amortizes the socket: ~1 produce_many per
    (partition, flush) instead of one round trip per record, with nothing
    lost and per-partition order intact."""
    from repro_torch.data.ingest import IngestConfig, IngestRunner
    from repro_torch.data.sources import SyntheticRateSource

    broker = Broker()
    server = serve_broker(broker, str(tmp_path / "b.sock"))
    client = RemoteBroker(server.address)
    try:
        runner = IngestRunner(client)
        m = runner.add(SyntheticRateSource(rate=1e9, total=500),
                       IngestConfig(topic="t", partitions=2, poll_batch=100,
                                    flush_records=100, max_pending=1 << 30))
        runner.run_inline(timeout=60)
        assert runner.done
        assert m.produced == 500
        assert sum(broker.end_offsets("t")) == 500
        # 5 polls x 100 records -> 5 flushes x 2 partition groups
        assert m.produce_calls <= 10
        for p in range(2):                 # round-robin kept per-part order
            vals = [r.value for r in broker.read(OffsetRange("t", p, 0, 999))]
            assert vals == list(range(p, 500, 2))
    finally:
        client.close()
        server.stop()


def test_torch_ingest_flush_deadline_and_done():
    """A partially-filled buffer flushes when the oldest record ages past
    flush_interval, and done stays False until the buffer drains."""
    from repro_torch.data.ingest import IngestConfig, IngestRunner

    class Trickle:
        def __init__(self):
            self.sent = False
            self.exhausted = False

        def poll(self, max_records):
            if not self.sent:
                self.sent = True
                return [(b"k", "only-record")]
            return []

    broker = Broker()
    runner = IngestRunner(broker)
    source = Trickle()
    m = runner.add(source, IngestConfig(topic="t", flush_records=1000,
                                        flush_interval=0.05))
    runner.pump()
    assert broker.end_offsets("t") == [0]  # buffered, not yet produced
    assert m.produced == 0 and not runner.done
    time.sleep(0.06)
    runner.pump()                          # deadline flush
    assert broker.end_offsets("t") == [1]
    assert m.produced == 1
    source.exhausted = True
    assert runner.done


# -- shared-memory 'S' frames end to end -------------------------------------

def _shm_leftovers() -> list[str]:
    """Segments created by this process's servers still visible in /dev/shm
    (the pool names embed the creator pid, so other processes never alias)."""
    prefix = f"reprotorchshm_{os.getpid()}_"
    try:
        return [f for f in os.listdir("/dev/shm") if f.startswith(prefix)]
    except FileNotFoundError:             # pragma: no cover - non-Linux
        return []


def _wait_no_shm_leftovers(timeout: float = 5.0) -> list[str]:
    deadline = time.monotonic() + timeout
    leftovers = _shm_leftovers()
    while leftovers and time.monotonic() < deadline:
        time.sleep(0.02)
        leftovers = _shm_leftovers()
    return leftovers


def test_torch_shm_negotiated_same_host_end_to_end(served):
    """A same-host UDS client negotiates shm in hello; array-bearing
    produces ride 'S' frames (bulk bytes never on the socket), reads are
    exact, and closing the connection strands nothing in /dev/shm."""
    np = pytest.importorskip("numpy")
    broker, server, client = served
    client.create_topic("frames")
    arrs = [np.arange(i, i + 64 * 64, dtype=np.float32).reshape(64, 64)
            for i in range(6)]
    for i, a in enumerate(arrs):
        client.produce("frames", (i, a), key=f"f{i}".encode())
    assert client.shm_frames_sent == 6
    assert server.shm_frames == 6
    assert server.stats()["shm_segments"] >= 1
    recs = client.read(OffsetRange("frames", 0, 0, 10))
    for i, rec in enumerate(recs):
        idx, got = rec.value
        assert idx == i
        np.testing.assert_array_equal(got, arrs[i])
    client.close()
    assert _wait_no_shm_leftovers() == []


def test_torch_shm_kill_switch_fallback_parity(served, monkeypatch):
    """USE_SHM_FRAMES=False (and shm=False per client) falls back to plain
    'A' frames with identical results — the kill switch is pure mechanism."""
    import repro_torch.data.transport as tr

    broker, server, _ = served
    arr = np.arange(128 * 128, dtype=np.float32).reshape(128, 128)

    monkeypatch.setattr(tr, "USE_SHM_FRAMES", False)
    off = RemoteBroker(server.address)
    off.create_topic("t")
    off.produce("t", (0, arr))
    assert off.shm_frames_sent == 0 and server.shm_frames == 0
    off.close()

    monkeypatch.undo()
    optout = RemoteBroker(server.address, shm=False)   # per-client opt-out
    optout.produce("t", (1, arr))
    assert optout.shm_frames_sent == 0 and server.shm_frames == 0
    optout.close()

    on = RemoteBroker(server.address)
    on.produce("t", (2, arr))
    assert on.shm_frames_sent == 1 and server.shm_frames == 1
    recs = on.read(OffsetRange("t", 0, 0, 10))
    on.close()
    assert [r.value[0] for r in recs] == [0, 1, 2]
    for _, got in (r.value for r in recs):             # all three paths equal
        np.testing.assert_array_equal(got, arr)
    assert _wait_no_shm_leftovers() == []


def test_torch_attach_segment_never_touches_resource_tracker(monkeypatch):
    """Attaching a server-owned segment must neither register nor
    unregister it with this process's resource_tracker: a producer spawned
    via ``multiprocessing`` *shares* the server's tracker, so either call
    unbalances the server's own create/unlink pair and the shared tracker
    dies with a KeyError traceback when the server unlinks."""
    from multiprocessing import resource_tracker, shared_memory

    from repro_torch.data.transport import _attach_untracked, _close_shm

    seg = shared_memory.SharedMemory(
        create=True, size=4096,
        name=f"reprotorchshm_{os.getpid()}_attachtest")
    calls: list[tuple] = []
    try:
        monkeypatch.setattr(resource_tracker, "register",
                            lambda n, t: calls.append(("register", n, t)))
        monkeypatch.setattr(resource_tracker, "unregister",
                            lambda n, t: calls.append(("unregister", n, t)))
        shm = _attach_untracked(seg.name)
        assert shm.buf is not None and shm.size >= 4096
        _close_shm(shm)
        observed = list(calls)
        # the patched register must be restored, not left swallowing
        assert resource_tracker.register.__name__ == "<lambda>"
    finally:
        monkeypatch.undo()
        seg.close()
        seg.unlink()
    assert observed == []


def test_torch_shm_hello_refuses_foreign_host(served):
    """A hello claiming a different host token is denied shm (descriptors
    would name segments the peer cannot map)."""
    from repro_torch.data.transport import decode_message, send_message

    _, server, _ = served
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(5)
    sock.connect(server.address)
    try:
        send_message(sock, ("hello", ({"host": "elsewhere:0000",
                                       "shm": True},), {}))
        status, caps = decode_message(recv_frame(sock))
        assert status == "ok" and caps["shm"] is False
        # and an shm_alloc on the un-negotiated connection declines cleanly
        send_message(sock, ("shm_alloc", (1024,), {}))
        assert decode_message(recv_frame(sock)) == ("ok", None)
    finally:
        sock.close()


_CHAOS_PRODUCER = r"""
import sys
import numpy as np
from repro_torch.data.transport import RemoteBroker

client = RemoteBroker(sys.argv[1])
client.create_topic("chaos")
frame = np.ones((256, 256), dtype=np.float32)
client.produce("chaos", (0, frame))
print("READY", client.shm_frames_sent, flush=True)
while True:
    client.produce("chaos", (0, frame))
"""


def test_torch_sigkill_mid_produce_leaves_no_shm(tmp_path):
    """Chaos pin for the server-owned-segments design: SIGKILL a producer
    mid-stream — the server unlinks every segment the connection leased
    (nothing stranded in /dev/shm) and the dead producer's resource_tracker
    has nothing to complain about (attached segments were unregistered).
    Once /dev/shm is empty the server counts no segment: the handler drops
    the pool from its live set before it unlinks (the repaired order), so
    both hold with no wait beyond the reference's."""
    import signal
    import subprocess
    import sys

    broker = Broker()
    server = serve_broker(broker, str(tmp_path / "chaos.sock"))
    try:
        proc = subprocess.Popen(
            [sys.executable, "-c", _CHAOS_PRODUCER, server.address],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            line = proc.stdout.readline()
            assert line.split() == ["READY", "1"], \
                f"producer never negotiated shm: {line!r}"
            assert _shm_leftovers()        # segments live while it streams
            os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=10)
            # EOF arrives only once the producer's resource_tracker (the
            # last writer on the inherited pipe) has exited too — so this
            # read observes any leak warning it would ever print
            stderr = proc.stderr.read()
        finally:
            proc.stdout.close()
            proc.stderr.close()
        assert "resource_tracker" not in stderr, stderr
        assert "leaked" not in stderr, stderr
        assert _wait_no_shm_leftovers() == []
        assert server.stats()["shm_segments"] == 0
        assert broker.end_offsets("chaos")[0] >= 1   # it did stream for real
    finally:
        server.stop()


def test_torch_ingest_add_tolerates_create_race():
    """Two producers' check-then-create on one topic must not kill the
    loser (the topic appearing between topics() and create_topic)."""
    from repro_torch.data.ingest import IngestConfig, IngestRunner
    from repro_torch.data.sources import SyntheticRateSource

    class RacyBroker(Broker):
        def topics(self):
            return []                     # always claims the topic is absent

    broker = RacyBroker()
    runner = IngestRunner(broker)
    runner.add(SyntheticRateSource(rate=1e9, total=1), IngestConfig(topic="t"))
    runner.add(SyntheticRateSource(rate=1e9, total=1), IngestConfig(topic="t"))
    assert Broker.topics(broker) == ["t"]


# -- op allow-list parity ----------------------------------------------------

def test_torch_op_allowlist_parity():
    """Runtime complement to the static `transport-op-parity` rule: the
    _OPS allow-list, the server dispatch, and RemoteBroker's public
    surface must describe the same protocol — checked against the live
    objects, so ops built or decorated dynamically still count."""
    import inspect

    from repro_torch.data import transport as t

    # ops the transport itself answers without touching the broker
    server_local = {"ping", "stats", "hello", "shm_alloc"}
    # connection internals issued by _connect/_send_shm, not a public method
    connection_internal = {"hello", "shm_alloc"}

    # every broker-bound op in _OPS is a real callable on Broker — the
    # server's getattr(self.broker, op) can never fall over
    for op in sorted(t._OPS - server_local):
        assert callable(getattr(t.Broker, op, None)), (
            f"allow-listed op {op!r} is not a Broker method")

    # drive every public RemoteBroker method against a recording stub and
    # diff the ops it issues against the allow-list
    rb = t.RemoteBroker.__new__(t.RemoteBroker)
    issued: set[str] = set()
    rb._request = lambda op, *a, **k: issued.add(op)

    dummy = {"rng": t.OffsetRange("t", 0, 0, 0), "pairs": [],
             "topics": ["t"], "cursors": {}, "hwms": {}}

    def arg_for(param):
        if param.name in dummy:
            return dummy[param.name]
        if param.annotation in (int, "int"):
            return 0
        return "x"

    public = [name for name, fn in vars(t.RemoteBroker).items()
              if inspect.isfunction(fn) and not name.startswith("_")
              and name != "close"]
    for name in public:
        fn = getattr(rb, name)
        sig = inspect.signature(fn)
        args = [arg_for(p) for p in sig.parameters.values()
                if p.default is inspect.Parameter.empty
                and p.kind in (p.POSITIONAL_ONLY,
                               p.POSITIONAL_OR_KEYWORD)]
        fn(*args)

    unlisted = issued - t._OPS
    assert not unlisted, f"RemoteBroker issues ops outside _OPS: {unlisted}"
    uncovered = t._OPS - issued - connection_internal
    assert not uncovered, (
        f"allow-listed ops with no public RemoteBroker issuer: {uncovered}")


# -- the wire between the packages ---------------------------------------------

def _leftovers(prefix: str) -> list[str]:
    try:
        return [f for f in os.listdir("/dev/shm")
                if f.startswith(f"{prefix}_{os.getpid()}_")]
    except FileNotFoundError:             # pragma: no cover - non-Linux
        return []


_PACKAGES = {
    "port": (Broker, serve_broker, RemoteBroker, OffsetRange, port_transport,
             "repro_torch.core.broker", "reprotorchshm"),
    "ref": (JaxBroker, jax_transport.serve_broker, jax_transport.RemoteBroker,
            JaxOffsetRange, jax_transport, "repro.core.broker", "reproshm"),
}


def _frame_bytes_of(tr, obj) -> bytes:
    parts = tr.encode_message(obj)
    payload = b"".join(bytes(p) for p in parts)
    return struct.pack(">2sII", tr.MAGIC, len(payload),
                       zlib.crc32(payload)) + payload


@pytest.mark.parametrize("family", ["tcp", "uds"])
@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("port", "ref"), ("ref", "port")],
                         ids=["ref-client-port-server",
                              "port-client-ref-server"])
def test_torch_wire_between_packages(server_pkg, client_pkg, family,
                                     tmp_path, monkeypatch):
    """A client of one package against the other's server: ``produce_many``
    of detector frames (an ``'S'`` frame, negotiated on this host, and an
    ``'A'`` frame from a client that opts out), ``read``, ``commit`` and
    ``lag``, with results equal to the server's broker's own. Each side's
    allow-list names its own record types, so the peer's ``Record`` and
    ``OffsetRange`` are registered for the test (``register_safe``'s
    set, restored afterwards)."""
    s_broker, s_serve, _, s_range, s_tr, s_mod, s_prefix = \
        _PACKAGES[server_pkg]
    _, _, c_remote, c_range, c_tr, c_mod, _ = _PACKAGES[client_pkg]
    for tr, other in ((s_tr, c_mod), (c_tr, s_mod)):
        monkeypatch.setattr(tr, "_SAFE_GLOBALS", tr._SAFE_GLOBALS | {
            (other, "Record"), (other, "OffsetRange")})
    backing = s_broker()
    address = (str(tmp_path / "b.sock") if family == "uds"
               else ("127.0.0.1", 0))
    server = s_serve(backing, address)
    client = c_remote(server.address, max_retries=2, retry_delay=0.01)
    plain = c_remote(server.address, shm=False)
    rng = np.random.default_rng(5)
    frames = [rng.standard_normal((64, 64)).astype(np.float32)
              for _ in range(6)]
    try:
        client.create_topic("frames", 2)
        assert client.topics() == backing.topics() == ["frames"]
        assert client.produce_many(
            "frames", [(f"frame-{i:06d}".encode(), (i, f))
                       for i, f in enumerate(frames[:4])],
            partition=1) == [0, 1, 2, 3]
        assert client.shm_frames_sent == 1 and server.shm_frames == 1
        assert plain.produce_many(
            "frames", [(f"frame-{i:06d}".encode(), (i, frames[i]))
                       for i in (4, 5)], partition=1) == [4, 5]
        assert plain.shm_frames_sent == 0 and server.shm_frames == 1
        assert client.end_offsets("frames") == backing.end_offsets(
            "frames") == [0, 6]
        recs = client.read(c_range("frames", 1, 0, 10))
        held = backing.read(s_range("frames", 1, 0, 10))
        assert [r.key for r in recs] == [r.key for r in held] == [
            f"frame-{i:06d}".encode() for i in range(6)]
        assert [r.offset for r in recs] == list(range(6))
        for i, (rec, own) in enumerate(zip(recs, held)):
            assert rec.value[0] == own.value[0] == i
            np.testing.assert_array_equal(rec.value[1], frames[i])
            np.testing.assert_array_equal(own.value[1], frames[i])
        client.commit("frames", 1, 4)
        assert backing.committed("frames") == client.committed("frames") \
            == [0, 4]
        assert client.lag("frames") == backing.lag("frames") == 2
        with pytest.raises(ValueError):
            client.commit("frames", 1, 99)           # typed across the wire
    finally:
        client.close()
        plain.close()
        server.stop()
    deadline = time.monotonic() + 5
    while _leftovers(s_prefix) and time.monotonic() < deadline:
        time.sleep(0.02)
    assert _leftovers(s_prefix) == []


def test_torch_allow_list_refuses_the_other_packages_classes(served):
    """Without registration the port's server refuses the reference's
    ``OffsetRange`` before instantiating it: cross-package traffic carries
    arrays, primitives and tuples unless a class is registered."""
    _, server, client = served
    client.create_topic("t")
    client.produce("t", (1, np.arange(3)))
    ref = jax_transport.RemoteBroker(server.address)
    try:
        assert ref.end_offsets("t") == [1]       # primitives cross fine
        with pytest.raises(jax_transport.TransportError,
                           match="refusing to unpickle "
                                 "repro.core.broker.OffsetRange"):
            ref.read(JaxOffsetRange("t", 0, 0, 1))
        assert ref.ping()
    finally:
        ref.close()


_WIRE_MESSAGES = {
    "produce_many": ("produce_many",
                     ("frames", [(b"frame-000000",
                                  (0, np.arange(4096, dtype=np.float32)
                                   .reshape(64, 64))),
                                 (b"frame-000001",
                                  (1, np.ones((64, 64), np.float32)))]),
                     {"partition": 1, "timestamp": 2.5}),
    "commit": ("commit", ("frames", 0, 5),
               {"group": "", "consumer": None, "generation": None}),
    "hello": ("hello", ({"host": "host:boot", "shm": True},), {}),
    "ok": ("ok", [0, 1, 2]),
}


@pytest.mark.parametrize("name", sorted(_WIRE_MESSAGES))
def test_torch_wire_bytes_equal_the_reference(name):
    """The same message framed by each package is the same bytes: header,
    kind byte, skeleton and array regions; as an ``'S'`` payload over the
    same segment name too."""
    msg = _WIRE_MESSAGES[name]
    assert (_frame_bytes_of(port_transport, msg)
            == _frame_bytes_of(jax_transport, msg))
    parts = port_transport.encode_message(msg)
    if len(parts) >= 3:
        size = sum(memoryview(b).nbytes for b in parts[2:])
        seg_a, seg_b = bytearray(size), bytearray(size)
        ref_parts = jax_transport.encode_message(msg)
        assert (port_transport.build_shm_payload(parts[1], parts[2:], "seg",
                                                 memoryview(seg_a))
                == jax_transport.build_shm_payload(
                    ref_parts[1], ref_parts[2:], "seg", memoryview(seg_b)))
        assert seg_a == seg_b


# the consumer-group and replication ops, the last the port's server took on
_DEFERRED_OPS = sorted([
    "join_group", "heartbeat", "sync_group", "leave_group", "describe_group",
    "fetch_frames", "replica_sync", "replica_hwm", "broker_epoch", "promote",
    "fence"])


def test_torch_deferred_ops_are_the_group_and_replication_protocol():
    """The port's server executes the reference's op set, the group and
    replication protocol included."""
    assert port_transport._OPS == jax_transport._OPS
    assert set(_DEFERRED_OPS) <= port_transport._OPS


@pytest.mark.parametrize("op", _DEFERRED_OPS)
def test_torch_server_answers_deferred_ops_as_unknown(op, served, tmp_path):
    """Each group and replication op, sent with no arguments, gets the same
    answer from the port's server as from the reference's server: the op is
    known, so the broker method runs (the two that take no arguments
    answer) or its own argument check refuses, and the connection stays
    up."""
    from repro_torch.data.transport import decode_message, send_message

    def answer(address):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(5)
        sock.connect(address)
        try:
            send_message(sock, (op, (), {}))
            got = decode_message(recv_frame(sock))
            send_message(sock, ("ping", (), {}))
            assert decode_message(recv_frame(sock)) == ("ok", "pong")
        finally:
            sock.close()
        return got

    _, server, client = served
    ref_server = jax_transport.serve_broker(JaxBroker(),
                                            str(tmp_path / "ref.sock"))
    try:
        got = answer(server.address)
        assert got == answer(ref_server.address)
    finally:
        ref_server.stop()
    assert got[0] == "ok" or got[:2] == ("err", "TypeError")
    assert "unknown op" not in repr(got)
    assert client.ping()


def test_torch_shm_pool_leaves_the_live_set_before_it_unlinks(served,
                                                              monkeypatch):
    """The repaired release order: when a connection's pool unlinks its
    segments, the server has already dropped the pool from its live set, so
    ``stats()`` never counts segments that are gone from /dev/shm."""
    _, server, client = served
    seen = []
    release = port_transport._ShmPool.release_all

    def spy(pool):
        seen.append((pool in list(server._shm_pools),
                     server.stats()["shm_segments"], _shm_leftovers() != []))
        release(pool)

    monkeypatch.setattr(port_transport._ShmPool, "release_all", spy)
    client.create_topic("frames")
    client.produce("frames", (0, np.ones((64, 64), np.float32)))
    assert client.shm_frames_sent == 1 and server.stats()["shm_segments"] == 1
    client.close()
    deadline = time.monotonic() + 5
    while not seen and time.monotonic() < deadline:
        time.sleep(0.01)
    assert seen == [(False, 0, True)]
    assert _wait_no_shm_leftovers() == []


def test_torch_generation_commit_is_refused_typed_over_the_wire(served):
    """A commit naming a generation goes through the group's coordinator: a
    stale generation is refused before it lands, with its type across the
    socket, and nothing is committed; the live generation commits."""
    from repro_torch.data.groups import GroupError, StaleGenerationError

    broker, _, client = served
    client.create_topic("t")
    client.produce("t", 1)
    with pytest.raises(GroupError, match="unknown group"):
        client.commit("t", 0, 1, group="g", consumer="c", generation=1)
    gen = client.join_group("g", "c", ["t"])["generation"]
    with pytest.raises(StaleGenerationError):
        client.commit("t", 0, 1, group="g", consumer="c", generation=gen + 1)
    assert broker.committed("t", group="g") == [0]
    client.commit("t", 0, 1, group="g", consumer="c", generation=gen)
    assert client.committed("t", group="g") == [1]
