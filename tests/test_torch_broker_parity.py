"""The port's broker contract parity matrix on the CPU: the counterpart of
tests/test_broker_parity.py.

Every test runs against six interchangeable port backends — the
in-process :class:`Broker`, :class:`RemoteBroker` over TCP and over a Unix
domain socket, a :class:`Broker` storing on disk through
``DurableLogFactory``, a replicated primary and follower behind
:class:`FailoverBroker`, and a :class:`CodecBroker` compressing every value
losslessly — pinning the duck type the rest of the port (``IngestRunner``,
``StreamingContext``, ``TopicSource``) relies on: identical results,
identical error types, including ``produce_many``'s all-or-nothing
validation. Then replication across the packages: a port follower of a
reference primary and a reference follower of a port primary both hold
logs byte-identical to their primary's.

Every test runs with the port's lock tracing on and asserts afterwards that
the locks it took were acquired in no cyclic order.
"""
import os

import numpy as np
import pytest

from repro_torch.core.broker import COMMIT_TOPIC, Broker, OffsetRange
from repro_torch.data import locktrace
from repro_torch.data.codec import CodecBroker
from repro_torch.data.durable_log import DurableLogFactory
from repro_torch.data.replication import FailoverBroker, ReplicaFollower
from repro_torch.data.transport import RemoteBroker, serve_broker

BACKENDS = ("local", "durable", "uds", "tcp", "failover", "codec")


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


@pytest.fixture(params=BACKENDS)
def anybroker(request, tmp_path):
    if request.param == "local":
        yield Broker()
        return
    if request.param == "codec":
        # lossless zlib wrapper: encode on produce, decode on read must be
        # observationally invisible against the whole contract matrix
        yield CodecBroker(Broker(), codec="zlib")
        return
    if request.param == "durable":
        yield Broker(log_factory=DurableLogFactory(str(tmp_path / "wal")))
        return
    if request.param == "failover":
        # durable primary and a live follower, every call through the HA
        # client: replication and the resend window must be invisible to
        # the duck type (same results, same error types as every backend)
        backing = Broker(log_factory=DurableLogFactory(str(tmp_path / "p")),
                         commit_topic=COMMIT_TOPIC)
        server = serve_broker(backing, str(tmp_path / "p.sock"))
        follower = ReplicaFollower(server.address, str(tmp_path / "f"),
                                   poll_interval=0.005)
        faddr = follower.serve(str(tmp_path / "f.sock"))
        follower.start()
        client = FailoverBroker([server.address, faddr])
        yield client
        client.close()
        follower.stop()
        server.stop()
        return
    backing = Broker()
    address = (str(tmp_path / "b.sock") if request.param == "uds"
               else ("127.0.0.1", 0))
    server = serve_broker(backing, address)
    client = RemoteBroker(server.address, max_retries=2, retry_delay=0.01)
    yield client
    client.close()
    server.stop()


def test_torch_topic_lifecycle(anybroker):
    anybroker.create_topic("a", 2)
    anybroker.create_topic("b")
    assert anybroker.topics() == ["a", "b"]
    assert anybroker.num_partitions("a") == 2
    assert anybroker.num_partitions("b") == 1
    with pytest.raises(ValueError):
        anybroker.create_topic("a")        # duplicate
    with pytest.raises(KeyError):
        anybroker.end_offsets("missing")   # unknown


def test_torch_produce_read_roundtrip(anybroker):
    anybroker.create_topic("t", 2)
    for i in range(8):
        assert anybroker.produce("t", {"i": i}, key=f"k{i}".encode(),
                                 partition=i % 2) == i // 2
    assert anybroker.end_offsets("t") == [4, 4]
    recs = anybroker.read(OffsetRange("t", 1, 1, 3))
    assert [r.value for r in recs] == [{"i": 3}, {"i": 5}]
    assert [r.offset for r in recs] == [1, 2]
    assert [r.key for r in recs] == [b"k3", b"k5"]


def test_torch_produce_many_offsets_and_order(anybroker):
    anybroker.create_topic("t", 2)
    offs = anybroker.produce_many(
        "t", [(f"k{i}".encode(), i) for i in range(5)], partition=1)
    assert offs == [0, 1, 2, 3, 4]
    # a second batch continues the offset space
    assert anybroker.produce_many("t", [(None, 5), (None, 6)],
                                  partition=1) == [5, 6]
    got = anybroker.read(OffsetRange("t", 1, 0, 100))
    assert [r.value for r in got] == list(range(7))
    assert [r.offset for r in got] == list(range(7))
    assert anybroker.end_offsets("t") == [0, 7]
    assert anybroker.produce_many("t", []) == []


def test_torch_produce_many_key_routing(anybroker):
    """partition=None routes per pair by a *stable* key hash (CRC-32, not
    Python's per-process-salted hash()): same key -> same partition, in any
    process, in any restart — which is what lets a durable log's replayed
    history and a restarted producer's new records meet on one partition.
    Relative per-key order is preserved."""
    import zlib

    anybroker.create_topic("t", 3)
    pairs = [(f"k{i % 4}".encode(), i) for i in range(24)]
    anybroker.produce_many("t", pairs)
    for key in (b"k0", b"k1", b"k2", b"k3"):
        expect = zlib.crc32(key) % 3
        recs = anybroker.read(OffsetRange("t", expect, 0, 100))
        assert any(r.key == key for r in recs)
    assert sum(anybroker.end_offsets("t")) == 24
    where = {}
    for p in range(3):
        recs = anybroker.read(OffsetRange("t", p, 0, 100))
        by_key = {}
        for r in recs:
            where.setdefault(r.key, set()).add(p)
            by_key.setdefault(r.key, []).append(r.value)
        for vals in by_key.values():
            assert vals == sorted(vals)    # per-key order preserved
    assert all(len(ps) == 1 for ps in where.values())


def test_torch_produce_many_partial_failure_validation(anybroker):
    """Bad batches are all-or-nothing: validation failures append *nothing*,
    and the error type crosses the wire intact."""
    anybroker.create_topic("t", 2)
    anybroker.produce("t", "baseline", partition=0)
    with pytest.raises(KeyError):
        anybroker.produce_many("nope", [(None, 1)])
    for bad_partition in (-1, 2, 99):
        with pytest.raises(ValueError):
            anybroker.produce_many("t", [(None, 1)], partition=bad_partition)
    with pytest.raises(ValueError):        # malformed pair mid-batch...
        anybroker.produce_many("t", [(None, 1), (None, 2, 3)], partition=0)
    with pytest.raises(ValueError):
        anybroker.produce_many("t", [(None, 1), 7], partition=0)
    with pytest.raises(ValueError):        # unroutable key with partition=None
        anybroker.produce_many("t", [(b"good", 1), ([1, 2], 2)])
    # ...appended nothing, not a prefix
    assert anybroker.end_offsets("t") == [1, 0]
    assert [r.value for r in anybroker.read(OffsetRange("t", 0, 0, 10))] == \
        ["baseline"]


def test_torch_commit_monotonic_and_lag(anybroker):
    anybroker.create_topic("t", 2)
    anybroker.produce_many("t", [(None, i) for i in range(6)], partition=0)
    anybroker.produce_many("t", [(None, i) for i in range(4)], partition=1)
    assert anybroker.lag("t") == 10
    anybroker.commit("t", 0, 5)
    anybroker.commit("t", 0, 2)            # replay never rewinds progress
    anybroker.commit("t", 1, 4)
    assert anybroker.committed("t") == [5, 4]
    assert anybroker.lag("t") == 1
    with pytest.raises(ValueError):
        anybroker.commit("t", 0, 99)       # past the end
    with pytest.raises(ValueError):
        anybroker.commit("t", -1, 0)       # negative-index partition
    assert anybroker.committed("t") == [5, 4]


def test_torch_per_group_commit_isolation(anybroker):
    """Consumer groups commit and lag independently: two groups walk the
    same topic at their own pace, neither touches the default group's
    offsets, and the group enumeration crosses every backend intact."""
    anybroker.create_topic("t", 2)
    anybroker.produce_many("t", [(None, i) for i in range(6)], partition=0)
    anybroker.produce_many("t", [(None, i) for i in range(4)], partition=1)
    anybroker.commit("t", 0, 5, group="g1")
    anybroker.commit("t", 1, 2, group="g2")
    assert anybroker.committed("t", group="g1") == [5, 0]
    assert anybroker.committed("t", group="g2") == [0, 2]
    assert anybroker.committed("t") == [0, 0]      # default group untouched
    assert anybroker.lag("t", group="g1") == 5
    assert anybroker.lag("t", group="g2") == 8
    assert anybroker.lag("t") == 10
    assert sorted(anybroker.commit_groups("t")) == ["", "g1", "g2"]
    anybroker.commit("t", 0, 3, group="g1")        # replay never rewinds
    assert anybroker.committed("t", group="g1") == [5, 0]
    with pytest.raises(ValueError):
        anybroker.commit("t", 0, 99, group="g1")   # past the end


def test_torch_numpy_payloads_roundtrip_writable(anybroker):
    """Detector-style records: ndarray values survive every backend (array
    frames over the socket, raw segment bytes on disk) and come back
    writable and equal."""
    anybroker.create_topic("frames")
    arrs = [np.arange(i, i + 12, dtype=np.float32).reshape(3, 4)
            for i in range(3)]
    anybroker.produce_many("frames", [(f"f{i}".encode(), (i, a))
                                      for i, a in enumerate(arrs)],
                           partition=0)
    recs = anybroker.read(OffsetRange("frames", 0, 0, 10))
    assert len(recs) == 3
    for i, rec in enumerate(recs):
        idx, got = rec.value
        assert idx == i and got.dtype == np.float32
        np.testing.assert_array_equal(got, arrs[i])
        assert got.flags.writeable
        got += 1.0                         # must not raise


# -- replication across the packages ------------------------------------------

def _seg_bytes(root, topic, parts):
    out = {}
    for p in range(parts):
        pdir = root / topic / f"p{p:04d}"
        for name in sorted(os.listdir(pdir)):
            if name.endswith(".seg"):
                out[(p, name)] = (pdir / name).read_bytes()
    return out


@pytest.mark.parametrize("leader", ["reference", "port"])
def test_torch_follower_of_the_other_package_is_byte_identical(tmp_path,
                                                               leader):
    """A port :class:`ReplicaFollower` pulling from a reference primary, and
    a reference follower pulling from a port primary, over a Unix socket:
    each follower's segment files hold its primary's bytes, its records read
    back equal, its high-watermarks reach the primary, and ``read_frames``
    serves the same blobs from either package's log."""
    from repro.core.broker import COMMIT_TOPIC as REF_COMMIT_TOPIC
    from repro.core.broker import Broker as RefBroker
    from repro.data.durable_log import DurableLogFactory as RefFactory
    from repro.data.replication import ReplicaFollower as RefFollower
    from repro.data.transport import serve_broker as ref_serve

    if leader == "reference":
        primary = RefBroker(log_factory=RefFactory(str(tmp_path / "p")),
                            commit_topic=REF_COMMIT_TOPIC)
        server = ref_serve(primary, str(tmp_path / "p.sock"))
        follower = ReplicaFollower(server.address, str(tmp_path / "f"))
    else:
        primary = Broker(log_factory=DurableLogFactory(str(tmp_path / "p")),
                         commit_topic=COMMIT_TOPIC)
        server = serve_broker(primary, str(tmp_path / "p.sock"))
        follower = RefFollower(server.address, str(tmp_path / "f"))
    frames = [(f"frame-{i:06d}".encode(),
               (i, np.full((16, 16), i, np.float32))) for i in range(24)]
    try:
        primary.create_topic("frames", 2)
        primary.produce_many("frames", frames)
        primary.produce_many("frames", [(None, {"i": i}) for i in range(5)],
                             partition=1)
        primary.commit("frames", 0, 3, group="g")
        while follower.sync_once():
            pass
        ends = primary.end_offsets("frames")
        assert follower.broker.end_offsets("frames") == ends
        assert (_seg_bytes(tmp_path / "f", "frames", 2)
                == _seg_bytes(tmp_path / "p", "frames", 2) != {})
        assert (_seg_bytes(tmp_path / "f", COMMIT_TOPIC, 1)
                == _seg_bytes(tmp_path / "p", COMMIT_TOPIC, 1) != {})
        for p, end in enumerate(ends):
            got = follower.broker._topic("frames")[p].read(0, end)
            want = primary._topic("frames")[p].read(0, end)
            assert [(r.key, r.offset) for r in got] == \
                [(r.key, r.offset) for r in want]
            for a, b in zip(got, want):
                if isinstance(b.value, tuple):
                    assert a.value[0] == b.value[0]
                    np.testing.assert_array_equal(a.value[1], b.value[1])
                else:
                    assert a.value == b.value
            assert (follower.broker._topic("frames")[p].read_frames(0, end)
                    == primary._topic("frames")[p].read_frames(0, end))
        assert primary.replica_hwm()[follower.replica_id]["frames"] == ends
        follower.broker.promote(1)
        assert follower.broker.committed("frames", group="g") == [3, 0]
    finally:
        follower.stop()
        server.stop()
