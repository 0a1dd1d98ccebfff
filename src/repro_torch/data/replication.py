"""Broker HA: follower replication of durable segments, with failover; the
counterpart of ``repro/data/replication.py``.

A beamline never stops producing, so the broker must survive the loss of
the machine it runs on. Kafka gets this from replicated partitions:
followers fetch the leader's log segments byte for byte, and one of them
takes over when the leader dies, fenced by a monotonically increasing
*leader epoch*. This module builds that design from the port's own parts:

- :class:`ReplicaFollower` attaches to a primary's
  :class:`~repro_torch.data.transport.BrokerServer` and pulls committed
  record *frames* per (topic, partition). One ``replica_sync`` round trip is
  one whole pull round: the follower's local next-offsets go up (doubling
  as its high-watermark report — the primary-side map producers consult to
  learn what is safely replicated), the topic layout and every partition's
  new frames come back. The CRC frame format of
  :mod:`repro_torch.data.durable_log` **is** the wire format: frames ship
  verbatim as one blob with a length list, the follower re-verifies every
  CRC and appends the same bytes to its own
  :class:`~repro_torch.data.durable_log.DurableLogFactory` root, so primary
  and follower logs are byte-identical with dense equal offsets.

- :class:`FailoverBroker` is the client half: a
  :class:`~repro_torch.core.broker.Broker` duck type over *several*
  addresses (primary and standby followers). It finds the current primary
  by probing ``broker_epoch``, and when the primary dies mid-call it
  *promotes* a follower at a strictly higher epoch (``promote`` op — the
  follower starts accepting writes and rebuilds group/committed offsets
  from the replicated ``__commits`` topic), re-sends its unconfirmed
  produce batches, re-points itself, and *fences* the old primary should it
  ever return (``fence`` op, then
  :class:`~repro_torch.core.broker.BrokerFencedError` on every write a
  zombie would otherwise accept).

Durability contract: replication is asynchronous — a batch acked by the
primary may not have reached the follower when the primary dies. The client
therefore keeps every produced batch in a *resend window* until a
follower's reported high-watermark covers it; on failover the window is
re-sent to the new primary. With the idempotent-by-key sinks downstream this
means **no committed record is lost and duplicates are absorbed**:
at-least-once across a failover, exactly-once end to end — the contract a
plain :class:`~repro_torch.data.transport.RemoteBroker` retry already has.
With no follower attached ``replica_hwm`` is empty and the window collapses
to "primary ack = committed".
"""
from __future__ import annotations

import os
import threading
import time
import zlib
from typing import Any, Callable, Sequence

from repro_torch.core.broker import (COMMIT_TOPIC, Broker,
                                     BrokerFencedError, NotPrimaryError,
                                     OffsetRange, Record, _route_partition)
# imported for its side effect: the group errors' wire names must be
# registered before a failover client can tell them from a lost connection
from repro_torch.data import groups  # noqa: F401
from repro_torch.data.durable_log import _REC_HEADER, DurableLogFactory
from repro_torch.data.locktrace import new_lock, new_rlock
from repro_torch.data.metrics import get_registry
from repro_torch.data.transport import (FrameError, RemoteBroker,
                                        TransportError, decode_message,
                                        serve_broker)
from repro_torch.utils import get_logger

log = get_logger(__name__)

# Errors that mean "this broker cannot serve the call, another one might":
# connectivity loss, a fenced zombie, an unpromoted replica. Everything else
# (GroupError, ValueError, ...) is the caller's problem and propagates.
_FAILOVER_ERRORS = (TransportError, BrokerFencedError, NotPrimaryError)

_EPOCH_FILE = "EPOCH"


def _read_epoch(root: str) -> int:
    try:
        with open(os.path.join(root, _EPOCH_FILE)) as fh:
            return int(fh.read().strip() or 0)
    except (FileNotFoundError, ValueError):
        return 0


def _write_epoch(root: str, epoch: int) -> None:
    """Durably record the epoch this broker last served at, so a restarted
    promoted broker resumes *above* it instead of back at 0 (where the
    fencing comparison would no longer protect the log)."""
    tmp = os.path.join(root, _EPOCH_FILE + ".tmp")
    with open(tmp, "w") as fh:
        fh.write(str(int(epoch)))
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, os.path.join(root, _EPOCH_FILE))


class ReplicaFollower:
    """Pull-replicate a primary broker's partition logs into a local one.

    ``primary_address`` is the primary's :class:`BrokerServer` address;
    ``root`` the follower-local :class:`DurableLogFactory` directory. The
    follower's own broker starts as a read-only replica
    (``writable=False`` — produce/commit/join raise
    :class:`NotPrimaryError` until promotion) and can be served to clients
    from the start via :meth:`serve`; a
    :class:`FailoverBroker` promotes it through that server when the
    primary dies. The pull loop:

    1. sends ``{topic: [next_offset, ...]}`` — the replication cursors,
       which the primary also records as this replica's high-watermarks —
       in a single ``replica_sync`` round trip,
    2. mirrors any new primary topics locally (same partition counts),
    3. appends the raw CRC frames that came back *verbatim*
       (CRC re-verified) with
       :meth:`~repro_torch.data.durable_log.DurablePartitionLog.append_frames`,
    4. on promotion (detected by the local broker turning writable) writes
       ``root/EPOCH`` and stops pulling — this broker is the primary now.

    A primary outage does not kill the loop: it idles and retries, so a
    recovered (re-fenced) primary's history is still drained if promotion
    never happened.
    """

    def __init__(self, primary_address: Any, root: str,
                 replica_id: str | None = None, poll_interval: float = 0.02,
                 max_bytes: int = 4 * 1024 * 1024,
                 commit_topic: str | None = COMMIT_TOPIC,
                 **log_kwargs: Any) -> None:
        self.root = str(root)
        self.factory = DurableLogFactory(self.root, **log_kwargs)
        self.broker = Broker(log_factory=self.factory,
                             commit_topic=commit_topic, writable=False,
                             epoch=_read_epoch(self.root))
        self.factory.restore(self.broker)   # reopen a prior run's segments
        # persist the epoch the moment a client promotes us through the
        # server — the pull loop may be mid-sleep, and a crash before its
        # next wakeup must not lose the promotion
        self.broker.on_promote = lambda b: _write_epoch(self.root, b.epoch)
        self.primary = RemoteBroker(primary_address, connect_timeout=2.0,
                                    max_retries=1, retry_delay=0.05)
        self.replica_id = replica_id or f"replica-{os.getpid()}"
        self.poll_interval = poll_interval
        self.max_bytes = max_bytes
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._server = None
        # the pull thread writes the lag and frame counters that sync_once
        # callers and gauge scrapes read
        self._stats_lock = new_lock("ReplicaFollower._stats_lock")
        self._last_lag = 0
        self.frames_replicated = 0
        reg = get_registry()
        self._m_frames = reg.counter(
            "replication_frames_total",
            "record frames pulled from the primary and appended locally")
        self._m_rounds = reg.counter(
            "replication_rounds_total",
            "replication pull rounds completed against the primary")
        reg.gauge("replication_lag_records",
                  "records the primary holds that this follower does not "
                  "(as of the last pull round)",
                  callback=lambda: self._last_lag)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ReplicaFollower":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="replica-follower")
        self._thread.start()
        return self

    def serve(self, address: Any = ("127.0.0.1", 0)) -> Any:
        """Serve the follower-local broker (read-only until promoted) and
        return the bound address — what a :class:`FailoverBroker` lists as
        the standby."""
        self._server = serve_broker(self.broker, address)
        return self._server.address

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._server is not None:
            self._server.stop()
            self._server = None
        self.primary.close()
        for topic in self.broker.topics():
            for plog in self.broker._topic(topic):
                closer = getattr(plog, "close", None)
                if closer is not None:
                    closer()

    def __enter__(self) -> "ReplicaFollower":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- promotion ---------------------------------------------------------
    @property
    def promoted(self) -> bool:
        return self.broker.broker_epoch()["writable"]

    def promote(self, epoch: int) -> dict:
        """In-process promotion (tests, single-process topologies); remote
        clients promote through :meth:`serve`'s server instead."""
        return self.broker.promote(epoch)

    # -- pull loop ---------------------------------------------------------
    def hwms(self) -> dict[str, list[int]]:
        """This follower's replicated next-offsets per (topic, partition)."""
        return {topic: [plog.end_offset()
                        for plog in self.broker._topic(topic)]
                for topic in self.broker.topics()}

    def sync_once(self) -> int:
        """One pull round — a single ``replica_sync`` round trip: report
        the local next-offsets as high-watermarks (even on idle rounds: the
        first report is what makes the primary's ``replica_hwm()``
        non-empty, arming producers' resend windows), mirror any new
        topics, and append the frames that came back. Returns the number of
        frames replicated (0 = fully caught up)."""
        resp = self.primary.replica_sync(self.replica_id, self.hwms(),
                                         max_bytes=self.max_bytes)
        synced, lag = 0, 0
        local = set(self.broker.topics())
        for topic, nparts in resp["topics"].items():
            if topic not in local:
                self.broker.create_topic(topic, nparts)
        for topic, entries in resp["parts"].items():
            plogs = self.broker._topic(topic)
            for p, (blob, lengths, nxt, end) in enumerate(entries):
                plog = plogs[p]
                if lengths:
                    self._append(plog, blob, lengths)
                    synced += len(lengths)
                lag += max(0, end - plog.end_offset())
        with self._stats_lock:
            # pull thread writes, gauge scrapes and test assertions read
            self.frames_replicated += synced
            self._last_lag = lag
        self._m_frames.inc(synced)
        self._m_rounds.inc()
        return synced

    @staticmethod
    def _append(plog, blob: bytes, lengths: Sequence[int]) -> None:
        if sum(lengths) != len(blob):
            raise FrameError(
                f"replication blob is {len(blob)} bytes but its frame "
                f"lengths sum to {sum(lengths)} (truncated in transit)")
        view = memoryview(blob)
        frames: list[bytes] = []
        cut = 0
        for size in lengths:
            frames.append(bytes(view[cut:cut + size]))
            cut += size
        appender = getattr(plog, "append_frames", None)
        if appender is not None:           # durable log: verbatim bytes,
            appender(frames)               # CRC-verified before landing
            return
        # in-memory local log: verify the frame, then decode and append
        for frame in frames:
            length, crc = _REC_HEADER.unpack_from(frame)
            body = memoryview(frame)[_REC_HEADER.size:]
            if length != len(body) or zlib.crc32(body) != crc:
                raise FrameError("replicated frame failed its CRC check")
            key, value, ts = decode_message(bytearray(body))
            plog.append(key, value, ts)

    def _run(self) -> None:
        while not self._stop.is_set():
            if self.promoted:
                # a FailoverBroker promoted us through the server: record
                # the epoch durably and leave the follower role for good
                _write_epoch(self.root, self.broker.epoch)
                log.info("replica %s promoted to primary at epoch %d",
                         self.replica_id, self.broker.epoch)
                return
            try:
                self.sync_once()
            except _FAILOVER_ERRORS + (FrameError, OSError) as e:
                # primary gone (or mid-restart): idle until it returns or a
                # client promotes us — both are normal, neither kills the loop
                log.debug("replication pull failed (primary down?): %s", e)
            except (KeyError, ValueError) as e:
                log.warning("replication pull skipped a round: %s", e)
            # pace every round: back-to-back pulls against a live primary
            # tax its produce path, and replication lag is bounded by one
            # poll plus one max_bytes transfer, not by how often the
            # follower can hammer the wire
            self._stop.wait(self.poll_interval)


class _Pending:
    """One produced-but-not-yet-replicated batch in the resend window."""

    __slots__ = ("topic", "needs", "payload")

    def __init__(self, topic: str, needs: dict[int, int],
                 payload: tuple) -> None:
        self.topic = topic
        self.needs = needs                 # partition -> required next offset
        self.payload = payload             # (op, args, kwargs) for resend


class FailoverBroker:
    """Client-side HA wrapper: a :class:`Broker` duck type over a primary
    and its standby replicas, with automatic failover.

    ``addresses`` lists every broker server (primary + followers served via
    :meth:`ReplicaFollower.serve`) in any order; the current primary is
    discovered by probing ``broker_epoch``. Every broker call goes to the
    active primary; when it fails with a connectivity or fencing error the
    wrapper *fails over*: probe all addresses, promote the best reachable
    candidate at a strictly higher epoch, re-send the unconfirmed produce
    window, fence any stale writable broker, bump :attr:`failovers` and
    notify listeners — then the call retries transparently. Producers and
    consumers built on the ``Broker`` duck type (``IngestRunner``,
    ``StreamingContext``, ``GroupConsumer``) ride through a primary SIGKILL
    without code changes; consumers watch :attr:`failovers` to know the
    offset space may have rewound (``StreamingContext`` rebases to committed
    offsets when it changes).

    The resend window is the durability half (module docstring): produced
    batches are held until ``replica_hwm`` shows a follower covering their
    offsets, and re-sent to the new primary on failover. Duplicates are
    possible (at-least-once), lost committed records are not — except
    records no follower ever saw *and* whose producer also died, the
    irreducible window of asynchronous replication.
    """

    def __init__(self, addresses: Sequence[Any], connect_timeout: float = 2.0,
                 max_retries: int = 2, retry_delay: float = 0.05,
                 confirm_interval: float = 0.05) -> None:
        if not addresses:
            raise ValueError("FailoverBroker needs at least one address")
        self._addrs = list(addresses)
        self._clients: dict[Any, RemoteBroker] = {
            addr: RemoteBroker(addr, connect_timeout=connect_timeout,
                               max_retries=max_retries,
                               retry_delay=retry_delay)
            for addr in self._addrs}
        self._lock = new_rlock("FailoverBroker._lock")
        self._pending: list[_Pending] = []
        self._nparts_cache: dict[str, int] = {}
        self._listeners: list[Callable[["FailoverBroker"], None]] = []
        self._confirm_interval = confirm_interval
        self._last_confirm = 0.0
        self.epoch = 0
        self.failovers = 0
        reg = get_registry()
        self._m_failovers = reg.counter(
            "replication_failovers_total",
            "primary failovers performed (follower promoted + repointed)")
        reg.gauge("replication_pending_batches",
                  "produced batches awaiting follower replication "
                  "(the failover resend window)",
                  callback=lambda: len(self._pending))
        self._active = self._elect(avoid=None)[0]

    # -- membership --------------------------------------------------------
    @property
    def active_address(self) -> Any:
        return self._active

    def add_failover_listener(
            self, fn: Callable[["FailoverBroker"], None]) -> None:
        """``fn(self)`` runs after each completed failover (promotion +
        resend + fencing) — e.g. to re-point monitoring."""
        self._listeners.append(fn)

    def _client(self, addr: Any) -> RemoteBroker:
        return self._clients[addr]

    def _probe(self) -> dict[Any, dict]:
        states: dict[Any, dict] = {}
        for addr in self._addrs:
            try:
                states[addr] = self._client(addr).broker_epoch()
            except _FAILOVER_ERRORS:
                continue
        return states

    def _elect(self, avoid: Any) -> tuple[Any, bool]:
        """Pick (or make) a primary. Prefers an already-writable broker at
        our epoch or above; otherwise promotes the best reachable candidate
        at a strictly higher epoch. Returns ``(address, promoted)``."""
        states = self._probe()
        if not states:
            raise TransportError(
                f"no broker reachable among {self._addrs!r}")
        writable = sorted(
            ((st["epoch"], addr) for addr, st in states.items()
             if st["writable"] and st["epoch"] >= self.epoch
             and addr != avoid),
            reverse=True)
        if writable:
            epoch, addr = writable[0]
            self.epoch = max(self.epoch, epoch)
            return addr, False
        new_epoch = max([self.epoch]
                        + [st["epoch"] for st in states.values()]) + 1
        candidates = [a for a in states if a != avoid] or list(states)
        for addr in candidates:
            try:
                self._client(addr).promote(new_epoch)
            except _FAILOVER_ERRORS + (ValueError,) as e:
                log.warning("promotion of %r at epoch %d failed: %s",
                            addr, new_epoch, e)
                continue
            self.epoch = new_epoch
            return addr, True
        raise TransportError(
            f"no promotable broker among {self._addrs!r} "
            f"(epoch {new_epoch})")

    def _failover(self) -> None:
        failed = self._active
        addr, promoted = self._elect(avoid=failed)
        self._active = addr
        self.failovers += 1
        self._m_failovers.inc()
        log.warning("failed over from %r to %r (epoch %d, promoted=%s, "
                    "resending %d pending batches)", failed, addr,
                    self.epoch, promoted, len(self._pending))
        self._resend_pending()
        self.fence_stale()
        self._nparts_cache.clear()
        for fn in list(self._listeners):
            try:
                fn(self)
            except Exception as e:        # listener bugs don't block traffic
                log.warning("failover listener raised %r", e)

    def fence_stale(self) -> list[Any]:
        """Fence every reachable non-active broker still writable at an
        older epoch (a zombie primary that came back). Returns the addresses
        fenced. Runs after each failover; call it directly when a known-dead
        primary is restarted."""
        fenced = []
        for addr, st in self._probe().items():
            if addr == self._active:
                continue
            if st["writable"] and st["epoch"] < self.epoch:
                try:
                    self._client(addr).fence(self.epoch)
                    fenced.append(addr)
                except _FAILOVER_ERRORS + (ValueError,):
                    continue
        return fenced

    # -- call plumbing -----------------------------------------------------
    def _call(self, op: str, *args: Any, **kwargs: Any) -> Any:
        last: Exception | None = None
        with self._lock:
            for _ in range(len(self._addrs) + 1):
                try:
                    return getattr(self._client(self._active),
                                   op)(*args, **kwargs)
                except _FAILOVER_ERRORS as e:
                    last = e
                    self._failover()
        raise TransportError(
            f"{op} failed despite failover across {self._addrs!r}: {last}"
        ) from last

    def _nparts(self, topic: str) -> int:
        n = self._nparts_cache.get(topic)
        if n is None:
            n = self._nparts_cache[topic] = self._call("num_partitions",
                                                       topic)
        return n

    # -- resend window -----------------------------------------------------
    def _track(self, topic: str, pairs: Sequence[tuple],
               partition: int | None, offsets: Sequence[int],
               payload: tuple) -> None:
        nparts = self._nparts(topic)
        needs: dict[int, int] = {}
        for (key, _value), off in zip(pairs, offsets):
            p = partition if partition is not None \
                else _route_partition(key, nparts)
            needs[p] = max(needs.get(p, 0), off + 1)
        self._pending.append(_Pending(topic, needs, payload))

    def _resend_pending(self) -> None:
        """Replay the unconfirmed window against the (new) active primary.
        The new primary's log may be missing the unreplicated tail, so each
        batch's required offsets are recomputed from the re-append."""
        client = self._client(self._active)
        for entry in self._pending:
            op, args, kwargs = entry.payload
            result = getattr(client, op)(*args, **kwargs)
            if op == "produce":
                pairs, offsets = [(kwargs.get("key"), args[1])], [result]
            else:
                pairs, offsets = args[1], result
            topic = args[0]
            nparts = client.num_partitions(topic)
            needs: dict[int, int] = {}
            for (key, _value), off in zip(pairs, offsets):
                p = kwargs.get("partition")
                if p is None:
                    p = _route_partition(key, nparts)
                needs[p] = max(needs.get(p, 0), off + 1)
            entry.needs = needs

    def _confirm(self) -> None:
        self._last_confirm = time.monotonic()
        try:
            hwms = self._call("replica_hwm")
        except TransportError:
            return
        if not hwms:
            # nobody has reported a high-watermark yet. Distinguish "no
            # follower in this deployment" (primary ack is all the
            # durability there is — pre-HA semantics, window collapses)
            # from "follower attached but its first report hasn't landed"
            # (clearing now would silently void the no-loss guarantee).
            if any(not st["writable"] for st in self._probe().values()):
                return                     # a replica exists: keep waiting
            self._pending.clear()
            return

        def covered(entry: _Pending) -> bool:
            for p, need in entry.needs.items():
                if not any(len(m.get(entry.topic, [])) > p
                           and m[entry.topic][p] >= need
                           for m in hwms.values()):
                    return False
            return True

        self._pending = [e for e in self._pending if not covered(e)]

    def _maybe_confirm(self) -> None:
        if self._pending and \
                time.monotonic() - self._last_confirm \
                >= self._confirm_interval:
            self._confirm()

    def flush(self, timeout: float | None = 5.0) -> bool:
        """Block until every produced batch is follower-covered (or the
        deployment has no followers). Returns ``False`` on timeout with
        batches still unconfirmed — the caller's data is *safe on the
        primary* but a primary loss right now would rely on the resend
        window in this process."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        while True:
            with self._lock:
                if not self._pending:
                    return True
                self._confirm()
                if not self._pending:
                    return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.01)

    @property
    def pending_batches(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- Broker surface: producers ----------------------------------------
    def produce(self, topic: str, value: Any, key: bytes | None = None,
                partition: int | None = None, timestamp: float = 0.0) -> int:
        with self._lock:
            offset = self._call("produce", topic, value, key=key,
                                partition=partition, timestamp=timestamp)
            self._track(topic, [(key, value)], partition, [offset],
                        ("produce", (topic, value),
                         {"key": key, "partition": partition,
                          "timestamp": timestamp}))
            self._maybe_confirm()
        return offset

    def produce_many(self, topic: str, pairs, partition: int | None = None,
                     timestamp: float = 0.0) -> list[int]:
        pairs = list(pairs)
        with self._lock:
            offsets = self._call("produce_many", topic, pairs,
                                 partition=partition, timestamp=timestamp)
            self._track(topic, pairs, partition, offsets,
                        ("produce_many", (topic, pairs),
                         {"partition": partition, "timestamp": timestamp}))
            self._maybe_confirm()
        return offsets

    # -- Broker surface: passthrough --------------------------------------
    def create_topic(self, topic: str, partitions: int = 1,
                     codec: str | None = None) -> None:
        self._call("create_topic", topic, partitions, codec=codec)

    def topic_codec(self, topic: str) -> str | None:
        return self._call("topic_codec", topic)

    def topics(self) -> list[str]:
        return self._call("topics")

    def num_partitions(self, topic: str) -> int:
        return self._call("num_partitions", topic)

    def read(self, rng: OffsetRange) -> list[Record]:
        return self._call("read", rng)

    def end_offset(self, topic: str, partition: int = 0) -> int:
        return self._call("end_offset", topic, partition)

    def end_offsets(self, topic: str) -> list[int]:
        return self._call("end_offsets", topic)

    def commit(self, topic: str, partition: int, offset: int,
               group: str = "", consumer: str | None = None,
               generation: int | None = None) -> None:
        self._call("commit", topic, partition, offset, group=group,
                   consumer=consumer, generation=generation)

    def committed(self, topic: str, group: str = "") -> list[int]:
        return self._call("committed", topic, group=group)

    def commit_groups(self, topic: str) -> list[str]:
        return self._call("commit_groups", topic)

    def lag(self, topic: str, group: str = "") -> int:
        return self._call("lag", topic, group=group)

    def join_group(self, group: str, consumer: str, topics,
                   session_timeout: float = 5.0) -> dict:
        return self._call("join_group", group, consumer, list(topics),
                          session_timeout=session_timeout)

    def heartbeat(self, group: str, consumer: str, generation: int) -> dict:
        return self._call("heartbeat", group, consumer, generation)

    def sync_group(self, group: str, consumer: str, generation: int) -> dict:
        return self._call("sync_group", group, consumer, generation)

    def leave_group(self, group: str, consumer: str) -> None:
        self._call("leave_group", group, consumer)

    def describe_group(self, group: str) -> dict:
        return self._call("describe_group", group)

    def ping(self) -> bool:
        return self._call("ping")

    def stats(self) -> dict:
        return self._call("stats")

    def replica_hwm(self, replica_id: str | None = None,
                    hwms: dict | None = None) -> dict:
        return self._call("replica_hwm", replica_id=replica_id, hwms=hwms)

    def broker_epoch(self) -> dict:
        return {"epoch": self.epoch, "writable": True}

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        with self._lock:
            for client in self._clients.values():
                client.close()

    def __enter__(self) -> "FailoverBroker":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
