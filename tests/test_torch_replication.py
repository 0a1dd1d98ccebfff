"""The port's broker HA on the CPU: the counterparts of
tests/test_replication.py — follower replication, promotion, fencing,
failover.

The acceptance bar: SIGKILL the primary mid-stream with a live consumer
group attached — the follower promotes, producers and consumers re-point
through :class:`FailoverBroker`, the stream resumes, and the consumed record
*set* equals an uncrashed run's (no committed record lost; duplicates
absorbed downstream by idempotent-by-key semantics, a set here). A fenced
old primary is refused if it comes back. Then the HA entry point,
``repro_torch.apps.ptycho.ha_failover``, at a small size on the CPU.

Every test runs with the port's lock tracing on and asserts afterwards that
the locks it took were acquired in no cyclic order.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from repro_torch.core.broker import (COMMIT_TOPIC, Broker, BrokerFencedError,
                                     NotPrimaryError, OffsetRange)
from repro_torch.core.dstream import StreamingContext
from repro_torch.core.rdd import Context
from repro_torch.data import locktrace
from repro_torch.data.durable_log import DurableLogFactory
from repro_torch.data.replication import FailoverBroker, ReplicaFollower
from repro_torch.data.transport import RemoteBroker, serve_broker


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


def _durable_primary(tmp_path, name="primary"):
    factory = DurableLogFactory(str(tmp_path / name))
    return Broker(log_factory=factory, commit_topic=COMMIT_TOPIC), factory


# -- replication: frames cross verbatim -------------------------------------

def test_torch_follower_log_is_byte_identical(tmp_path):
    primary, _ = _durable_primary(tmp_path)
    server = serve_broker(primary, str(tmp_path / "p.sock"))
    primary.create_topic("t", 2)
    primary.produce_many("t", [(f"k{i}".encode(), {"i": i})
                               for i in range(40)])
    fol = ReplicaFollower(server.address, str(tmp_path / "replica"))
    try:
        while fol.sync_once():
            pass
        assert fol.broker.end_offsets("t") == primary.end_offsets("t")
        # same records at the same offsets...
        for p in range(2):
            end = primary.end_offset("t", p)
            assert ([r.value for r in
                     fol.broker.read(OffsetRange("t", p, 0, end))]
                    == [r.value for r in
                        primary.read(OffsetRange("t", p, 0, end))])
        # ...and the segment *files* hold the same bytes: the CRC frame is
        # the wire format, shipped verbatim, so the logs are byte-identical
        for p in range(2):
            pdir = tmp_path / "primary" / "t" / f"p{p:04d}"
            fdir = tmp_path / "replica" / "t" / f"p{p:04d}"
            psegs = sorted(f for f in os.listdir(pdir)
                           if f.endswith(".seg"))
            assert psegs == sorted(f for f in os.listdir(fdir)
                                   if f.endswith(".seg"))
            for seg in psegs:
                assert (pdir / seg).read_bytes() == (fdir / seg).read_bytes()
        # the follower reported its high-watermarks back to the primary
        hwms = primary.replica_hwm()
        assert hwms[fol.replica_id]["t"] == primary.end_offsets("t")
    finally:
        fol.stop()
        server.stop()


def test_torch_inmemory_primary_is_replicable(tmp_path):
    """fetch_frames on an in-memory broker frames records on the fly; the
    durable follower still re-verifies CRCs and lands identical records."""
    primary = Broker()
    server = serve_broker(primary, str(tmp_path / "p.sock"))
    primary.create_topic("t", 1)
    primary.produce_many("t", [(None, i) for i in range(10)], partition=0)
    fol = ReplicaFollower(server.address, str(tmp_path / "replica"))
    try:
        while fol.sync_once():
            pass
        got = fol.broker.read(OffsetRange("t", 0, 0, 10))
        assert [r.value for r in got] == list(range(10))
        assert [r.offset for r in got] == list(range(10))
    finally:
        fol.stop()
        server.stop()


def _split(blob: bytes, lengths: list[int]) -> list[bytes]:
    """Cut a fetch_frames/read_frames blob back into individual frames."""
    out, cut = [], 0
    for n in lengths:
        out.append(bytes(blob[cut:cut + n]))
        cut += n
    return out


def test_torch_append_frames_rejects_corruption(tmp_path):
    log_ = DurableLogFactory(str(tmp_path / "wal"))(topic="t", partition=0)
    src = DurableLogFactory(str(tmp_path / "src"))(topic="t", partition=0)
    for i in range(3):
        src.append(b"k", i, 0.0)
    frames = _split(*src.read_frames(0, 3)[:2])
    bad = bytearray(frames[1])
    bad[-1] ^= 0xFF                       # flip one payload byte
    with pytest.raises(ValueError):
        log_.append_frames([frames[0], bytes(bad), frames[2]])
    assert log_.end_offset() == 0          # all-or-nothing: nothing landed
    assert log_.append_frames(frames) == [0, 1, 2]
    assert [r.value for r in log_.read(0, 3)] == [0, 1, 2]


# -- promotion & fencing matrix ----------------------------------------------

def test_torch_replica_rejects_writes_until_promoted():
    replica = Broker(writable=False)
    replica.create_topic("t", 1)           # mirroring topics is allowed
    with pytest.raises(NotPrimaryError):
        replica.produce("t", 1)
    with pytest.raises(NotPrimaryError):
        replica.produce_many("t", [(None, 1)])
    with pytest.raises(NotPrimaryError):
        replica.commit("t", 0, 0)
    with pytest.raises(NotPrimaryError):
        replica.join_group("g", "c1", ["t"])
    assert replica.broker_epoch() == {"epoch": 0, "writable": False}
    assert replica.promote(3) == {"epoch": 3, "promoted": True,
                                  "writable": True}
    assert replica.produce("t", 1) == 0    # writable now
    # idempotent across racing clients at the same (or an older) epoch
    assert replica.promote(3)["promoted"] is False
    with pytest.raises(ValueError):
        Broker(writable=False, epoch=5).promote(5)   # not strictly newer


def test_torch_fencing_rejects_zombie_writes():
    primary = Broker()
    primary.create_topic("t", 1)
    primary.produce("t", 0)
    with pytest.raises(ValueError):
        primary.fence(0)                   # stale fence attempt is rejected
    assert primary.fence(2)["writable"] is False
    for attempt in (lambda: primary.produce("t", 1),
                    lambda: primary.produce_many("t", [(None, 1)]),
                    lambda: primary.commit("t", 0, 1),
                    lambda: primary.join_group("g", "c", ["t"])):
        with pytest.raises(BrokerFencedError):
            attempt()
    assert primary.end_offset("t") == 1    # nothing slipped through
    # a fenced broker can only rejoin by promoting ABOVE the fence epoch
    with pytest.raises(ValueError):
        primary.promote(2)
    assert primary.promote(4)["promoted"] is True
    assert primary.produce("t", 1) == 1


def test_torch_fencing_errors_cross_the_wire_typed(tmp_path):
    replica = Broker(writable=False)
    replica.create_topic("t", 1)
    server = serve_broker(replica, str(tmp_path / "r.sock"))
    client = RemoteBroker(server.address, max_retries=1, retry_delay=0.01)
    try:
        with pytest.raises(NotPrimaryError):
            client.produce("t", 1)
        client.promote(1)
        assert client.produce("t", 1) == 0
        client.fence(9)
        with pytest.raises(BrokerFencedError):
            client.produce("t", 2)
        assert client.broker_epoch()["writable"] is False
    finally:
        client.close()
        server.stop()


# -- group/committed state across restart and failover ------------------------

def test_torch_restart_rebuilds_group_commits_from_commit_topic(tmp_path):
    """Broker restart durability matrix: committed offsets per group and the
    coordinator's generation floor survive (via the durable ``__commits``
    topic); group *membership* does not — members must rejoin, which is what
    keeps zombie members at stale generations fenced after a restart."""
    broker, factory = _durable_primary(tmp_path)
    broker.create_topic("t", 2)
    broker.produce_many("t", [(None, i) for i in range(8)], partition=0)
    broker.produce_many("t", [(None, i) for i in range(4)], partition=1)
    broker.commit("t", 0, 5, group="g1")
    broker.commit("t", 1, 3, group="g1")
    broker.commit("t", 0, 2, group="g2")
    out = broker.join_group("grp", "c1", ["t"])    # bumps grp generation
    gen = out["generation"]

    reborn = Broker(log_factory=DurableLogFactory(str(tmp_path / "primary")),
                    commit_topic=COMMIT_TOPIC)
    factory.restore(reborn)
    assert reborn.restore_commits() > 0
    assert reborn.committed("t", group="g1") == [5, 3]
    assert reborn.committed("t", group="g2") == [2, 0]
    # generation floor survived: the next join lands strictly above it
    assert reborn.join_group("grp", "c2", ["t"])["generation"] > gen
    # membership itself did not survive — c1 is unknown until it rejoins
    assert list(reborn.describe_group("grp")["members"]) == ["c2"]


def test_torch_restore_commits_clamps_to_local_log_end(tmp_path):
    """A replicated commit record can outrun replication of the data it
    points at; the rebuilt offset must clamp to the local log end or every
    reader would wedge waiting for records that do not exist."""
    broker, factory = _durable_primary(tmp_path)
    broker.create_topic("t", 1)
    broker.produce_many("t", [(None, i) for i in range(10)], partition=0)
    broker.commit("t", 0, 10, group="g")

    # follower-side rebuild where only 4 of the 10 records made it
    short = Broker(log_factory=DurableLogFactory(str(tmp_path / "f")),
                   commit_topic=COMMIT_TOPIC)
    short.create_topic("t", 1)
    short.create_topic(COMMIT_TOPIC, 1)
    frames = _split(*broker.fetch_frames("t", 0, 0)[:2])
    short._topic("t")[0].append_frames(frames[:4])
    cframes = _split(*broker.fetch_frames(COMMIT_TOPIC, 0, 0)[:2])
    short._topic(COMMIT_TOPIC)[0].append_frames(cframes)
    short.restore_commits()
    assert short.committed("t", group="g") == [4]


# -- failover: promotion + resend window --------------------------------------

def test_torch_failover_promotes_and_resends_unreplicated_tail(tmp_path):
    primary, _ = _durable_primary(tmp_path)
    pserver = serve_broker(primary, str(tmp_path / "p.sock"))
    primary.create_topic("t", 2)
    fol = ReplicaFollower(pserver.address, str(tmp_path / "replica"),
                          poll_interval=0.005)
    faddr = fol.serve(str(tmp_path / "f.sock"))
    fol.start()
    fb = FailoverBroker([pserver.address, faddr])
    try:
        fb.produce_many("t", [(f"k{i}".encode(), i) for i in range(30)])
        assert fb.flush(timeout=10)        # follower confirmed everything
        assert fb.pending_batches == 0
        assert fol.broker.end_offsets("t") == primary.end_offsets("t")

        # stall the pull loop, then produce a tail the follower never sees
        fol.poll_interval = 60
        time.sleep(0.05)
        fb.produce_many("t", [(b"tail%d" % i, 100 + i) for i in range(10)],
                        partition=0)
        assert fb.pending_batches >= 1     # unconfirmed: still in the window
        pserver.stop()                     # primary dies with the tail

        # next call fails over: follower promoted, tail re-sent, call served
        fb.produce_many("t", [(b"post", 999)], partition=1)
        assert fb.failovers == 1
        assert fb.epoch == 1
        assert fb.active_address == faddr
        assert fol.promoted
        got = {r.value
               for p in range(2)
               for r in fb.read(OffsetRange("t", p, 0,
                                            fb.end_offset("t", p)))}
        assert {100 + i for i in range(10)} <= got   # no committed loss
        assert 999 in got
        # the follower's EPOCH file pins the promotion durably
        deadline = time.monotonic() + 5
        while not os.path.exists(tmp_path / "replica" / "EPOCH"):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert (tmp_path / "replica" / "EPOCH").read_text() == "1"
    finally:
        fb.close()
        fol.stop()
        pserver.stop()


def test_torch_no_replica_degrades_to_primary_ack(tmp_path):
    """With no follower attached the resend window collapses: primary ack =
    committed (exactly the pre-HA contract)."""
    primary, _ = _durable_primary(tmp_path)
    server = serve_broker(primary, str(tmp_path / "p.sock"))
    fb = FailoverBroker([server.address])
    try:
        fb.create_topic("t", 1)
        fb.produce_many("t", [(None, i) for i in range(5)], partition=0)
        assert fb.flush(timeout=5)
        assert fb.pending_batches == 0
    finally:
        fb.close()
        server.stop()


def test_torch_streaming_context_rebases_cursor_after_failover():
    """After a failover the new primary's log may be shorter than the
    consumer's cursor (lost unreplicated tail): the context must clamp its
    start offsets or it would skip every record the new primary appends."""
    b = Broker()
    b.failovers = 0                       # quack like a FailoverBroker
    b.create_topic("t", 1)
    for i in range(6):
        b.produce("t", i)
    ctx = Context()
    sc = StreamingContext(ctx, b)
    sc.subscribe(["t"])
    seen = []
    sc.foreach_batch(lambda rdd, info: seen.extend(rdd.collect()))
    sc.run_one_batch()
    assert seen == [0, 1, 2, 3, 4, 5]

    # "failover": replace the log with a shorter replica (4 of 6 records)
    shorter = Broker()
    shorter.create_topic("t", 1)
    for i in range(4):
        shorter.produce("t", i)
    sc.broker = b = shorter
    b.failovers = 1
    assert sc.run_one_batch() is None      # rebase only; nothing new yet
    b.produce("t", 99)                     # lands at offset 4 < old cursor 6
    sc.run_one_batch()
    assert seen[6:] == [99]                # consumed, not silently skipped


# -- chaos acceptance: SIGKILL the primary mid-stream -------------------------

_PRIMARY_PROC = """\
import sys, time
from repro_torch.core.broker import Broker, COMMIT_TOPIC
from repro_torch.data.durable_log import DurableLogFactory
from repro_torch.data.transport import serve_broker
factory = DurableLogFactory(sys.argv[1])
broker = Broker(log_factory=factory, commit_topic=COMMIT_TOPIC)
factory.restore(broker)
broker.restore_commits()
serve_broker(broker, sys.argv[2])
print("ready", flush=True)
while True:
    time.sleep(1)
"""


def _spawn_primary(root, sock):
    if os.path.exists(sock):
        os.unlink(sock)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.dirname(__file__)), "src"),
         env.get("PYTHONPATH", "")])
    proc = subprocess.Popen([sys.executable, "-c", _PRIMARY_PROC,
                             str(root), sock],
                            stdout=subprocess.PIPE, env=env, text=True)
    assert proc.stdout.readline().strip() == "ready"
    return proc


def test_torch_chaos_sigkill_primary_with_live_consumer_group(tmp_path):
    psock = str(tmp_path / "p.sock")
    proc = _spawn_primary(tmp_path / "primary", psock)
    fol = fb = None
    try:
        fol = ReplicaFollower(psock, str(tmp_path / "replica"),
                              poll_interval=0.005)
        faddr = fol.serve(str(tmp_path / "f.sock"))
        fol.start()
        fb = FailoverBroker([psock, faddr])
        fb.create_topic("t", 2)

        consumed = set()
        sc = StreamingContext(Context(), fb)
        sc.subscribe(["t"])
        sc.join_group("grp", "c1", heartbeat_interval=0.05,
                      session_timeout=2.0)
        sc.foreach_batch(
            lambda rdd, info: consumed.update(v for v in rdd.collect()))

        total, chunk, kill_at = 200, 20, 100
        produced = set()
        for base in range(0, total, chunk):
            vals = list(range(base, base + chunk))
            fb.produce_many("t", [(str(v).encode(), v) for v in vals])
            produced.update(vals)
            if base + chunk == kill_at:
                proc.kill()                # SIGKILL mid-stream
                proc.wait()
            sc.run_one_batch()

        assert fb.failovers >= 1           # the stream rode through a death
        assert fb.active_address == faddr
        fb.flush(timeout=10)
        deadline = time.monotonic() + 20
        while consumed != produced and time.monotonic() < deadline:
            if sc.run_one_batch() is None:
                time.sleep(0.01)
        # the consumed SET equals the uncrashed run's: every committed
        # record arrived; duplicates (resent window) collapsed in the set
        assert consumed == produced

        # the old primary returns from the dead on the same address: it must
        # be fenced, not allowed to accept writes at its stale epoch
        proc = _spawn_primary(tmp_path / "primary", psock)
        assert fb.fence_stale() == [psock]
        zombie = RemoteBroker(psock, max_retries=1, retry_delay=0.01)
        try:
            with pytest.raises(BrokerFencedError):
                zombie.produce("t", -1, partition=0)
        finally:
            zombie.close()
    finally:
        if fb is not None:
            fb.close()
        if fol is not None:
            fol.stop()
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_torch_failover_inside_a_batch_rebases_instead_of_failing():
    """The broker fails over *inside* a batch, between its read and its
    commit, to a promoted log shorter than what the batch read. The
    reference's context raises the broker's ``ValueError`` (commit offset
    past the log end) out of ``run_one_batch``; the port's keeps its local
    progress, rebases at the next batch and consumes what the new primary
    appends, as it does for a failover between batches."""
    from repro.core import Broker as RefBroker
    from repro.core import Context as RefContext
    from repro.core import StreamingContext as RefStreamingContext

    def run(broker_cls, context_cls, stream_cls):
        b = broker_cls()
        b.failovers = 0                    # quack like a FailoverBroker
        b.create_topic("t", 1)
        for i in range(6):
            b.produce("t", i)
        shorter = broker_cls()             # the promoted replica: 4 of 6
        shorter.create_topic("t", 1)
        for i in range(4):
            shorter.produce("t", i)
        shorter.failovers = 1
        sc = stream_cls(context_cls(), b)
        sc.subscribe(["t"])
        seen = []

        def fn(rdd, info):
            seen.extend(rdd.collect())
            sc.broker = shorter            # the failover, mid-batch

        sc.foreach_batch(fn)
        sc.run_one_batch()
        assert sc.run_one_batch() is None  # the rebase; nothing new yet
        shorter.produce("t", 99)           # offset 4, below the old cursor
        sc.run_one_batch()
        return seen

    assert run(Broker, Context, StreamingContext) == [0, 1, 2, 3, 4, 5, 99]
    with pytest.raises(ValueError, match="commit offset 6 outside"):
        run(RefBroker, RefContext, RefStreamingContext)


class _Promotable:
    """A client that fails over the way a ``FailoverBroker`` does: every
    call goes to ``target``, and ``failovers`` counts the promotions."""

    def __init__(self, target):
        self.target = target
        self.failovers = 0

    def __getattr__(self, name):
        return getattr(self.target, name)


@pytest.mark.parametrize("short", [0, 1, 2])
@pytest.mark.parametrize("group", ["", "g"])
def test_torch_failover_inside_a_batch_commits_every_partition_again(
        short, group):
    """A mid-batch failover refuses the commit of partition ``short``, whose
    promoted log holds 4 of the 6 records the batch read. The commits of
    that batch that never reached the promoted broker (the refused one and
    those after it) are made again after the rebase, each clamped to the
    new primary's end, so the promoted broker's lag comes back to 0 with no
    new records; a record appended below the old cursor is consumed and
    committed too. In a group (``"g"``), the promoted broker's coordinator
    does not know the member: its commits are fenced, it rejoins, and
    commits the same offsets under the new generation."""
    old, promoted = Broker(), Broker()
    for b in (old, promoted):
        b.create_topic("t", 3)
    for p in range(3):
        for i in range(6):
            old.produce("t", (p, i), partition=p)
            if p != short or i < 4:
                promoted.produce("t", (p, i), partition=p)
    client = _Promotable(old)
    sc = StreamingContext(Context(), client)
    sc.subscribe(["t"])
    if group:
        sc.join_group(group, consumer_id="c0", heartbeat_interval=0.0)
    seen = []

    def fn(rdd, info):
        seen.extend(rdd.collect())
        if client.target is old:           # the failover, mid-batch
            client.target = promoted
            client.failovers = 1

    sc.foreach_batch(fn)
    try:
        sc.run_one_batch()
        assert sc.run_one_batch() is None  # the rebase and the recommit
        want = [6, 6, 6]
        want[short] = 4
        assert promoted.committed("t", group=group) == want
        assert promoted.lag("t", group=group) == 0
        promoted.produce("t", "x", partition=short)  # below the old cursor
        sc.run_one_batch()
        want[short] = 5
        assert promoted.committed("t", group=group) == want
        assert promoted.lag("t", group=group) == 0
        assert sorted(map(str, seen)) == sorted(map(str, [
            (p, i) for p in range(3) for i in range(6)] + ["x"]))
    finally:
        sc.close()


def test_torch_ha_failover_entry_point_on_the_jax_frames():
    """The HA entry point on the CPU at a small size: a durable primary in
    its own process SIGKILLed after 24 of 48 frames, the follower promoted
    at epoch 1 by whichever client fails over first, every frame id in the
    consumer's sink, every frame read back from the promoted broker equal to
    the one the producer simulated (by its CRC-32), photons and peak over
    the deduplicated frames equal to numpy's over the frames read back and
    over the JAX package's ``simulate`` frames of the same scan, the
    restarted zombie fenced, and no shared-memory segment left."""
    from repro.apps.ptycho.sim import simulate as jax_simulate
    from repro_torch.apps.ptycho.ha_failover import parse_args, run_ha_failover

    args = parse_args(["--frames", "48", "--batch", "8"])
    res = run_ha_failover(args, device="cpu")
    assert res["frame_ids"] == res["readback_ids"] == list(range(48))
    assert res["readback_equal"]
    assert res["duplicates"] == res["stored"] - 48 >= 0
    mags = np.asarray(jax_simulate(args.obj_size, args.probe_size,
                                   step=8).magnitudes[:48], np.float64)
    assert res["photons"] == pytest.approx(float((mags ** 2).sum()),
                                           rel=1e-5)
    assert res["peak"] == pytest.approx(float(mags.max()), rel=1e-5)
    assert res["photons"] == pytest.approx(res["readback_photons"], rel=1e-6)
    assert res["peak"] == pytest.approx(res["readback_peak"], rel=1e-6)
    for client in (res["producer"], res["consumer"]):
        assert client["failovers"] >= 1 and client["epoch"] == 1
    assert res["producer"]["flushed"] and res["producer"]["produced"] == 48
    assert res["kill_to_first_produce_s"] > 0
    assert len(res["fenced"]) == 1 and "fenced by epoch 1" in \
        res["zombie_error"]
    assert res["shm_left"] == []
