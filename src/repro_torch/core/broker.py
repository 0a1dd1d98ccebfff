"""An in-process message broker with Kafka semantics (paper §II, Fig. 7-8).

The counterpart of ``repro/core/broker.py``: topics split into partitions,
each partition an append-only, totally ordered log addressed by offsets,
with no order across partitions; records are (key, value) pairs.
:func:`create_rdd` is ``KafkaUtils.createRDD``: one RDD partition per
explicit ``OffsetRange`` read.

Storage sits behind the :class:`PartitionLog` protocol
(``append``/``read``/``end_offset``, plus an optional ``append_many`` for
the batched :meth:`Broker.produce_many`): :class:`Broker` composes one log
per (topic, partition) from its ``log_factory`` and never looks inside.
:class:`InMemoryPartitionLog` is the default;
:class:`~repro_torch.data.durable_log.DurablePartitionLog` keeps the log on
disk across restarts, and ``DurableLogFactory.restore(broker)`` reopens
every topic it finds. The multi-process path serves the whole broker over
a socket (:mod:`repro_torch.data.transport`), so the detector and the
reconstruction can live in different processes or on different hosts.

The broker also keeps *committed* (consumer-processed) offsets per topic
and consumer group — :meth:`Broker.commit` / :meth:`Broker.committed` /
:meth:`Broker.lag` — which the streaming context pushes after every
micro-batch; over the transport this is what lets a *remote* producer's
backpressure see how far the consumer got. A topic may name a payload codec
(:mod:`repro_torch.data.codec`), which producers and consumers apply; the
broker never looks inside a value. Each topic registers the reference's
four instruments in the metrics registry. Locks come from
:mod:`repro_torch.data.locktrace`.

The broker hosts the consumer groups' coordinator
(:mod:`repro_torch.data.groups`, created on first use): a commit that names
a ``generation`` is fenced by it, so a consumer the group has moved on from
cannot advance the group's offsets. For broker HA
(:mod:`repro_torch.data.replication`) a broker has a role: a *replica*
(``writable=False``) refuses writes until a client promotes it at a higher
*epoch*, and a primary fenced by a higher epoch refuses them for good. With
a ``commit_topic`` every group commit and generation is also appended to
that topic, which replicates like any other, so a promoted follower rebuilds
the groups' progress from it (:meth:`Broker.restore_commits`).
"""
from __future__ import annotations

import inspect
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Protocol, Sequence, runtime_checkable

from repro_torch.core.rdd import RDD, Context
from repro_torch.data.locktrace import new_lock
from repro_torch.data.metrics import get_registry

# Committed offsets are namespaced per consumer group; groupless callers
# (and the broker's own lag gauge) land on this default group.
DEFAULT_GROUP = ""

# Broker-side record of group/committed-offset advances, appended to this
# topic when Broker(commit_topic=...) is set. With a durable log factory the
# topic replicates to followers like any other, which is how a promoted
# follower rebuilds per-group committed offsets and the coordinator's
# generation floor (see repro_torch.data.replication and
# Broker.restore_commits).
COMMIT_TOPIC = "__commits"


class BrokerFencedError(RuntimeError):
    """This broker was fenced by a higher-epoch promotion: a follower took
    over while it was away, and accepting writes now would fork the log. A
    zombie primary raises this on every produce/commit after a returning
    client fences it (``Broker.fence``)."""


class NotPrimaryError(RuntimeError):
    """This broker is a replica (read-only follower): writes must go to the
    primary until ``Broker.promote`` makes this one the primary."""


@dataclass(frozen=True)
class Record:
    key: bytes | None
    value: Any
    offset: int
    timestamp: float = 0.0


@dataclass(frozen=True)
class OffsetRange:
    """Paper Fig. 8: ``OffsetRange(topic, partition, fromOffset, untilOffset)``."""
    topic: str
    partition: int
    start: int
    until: int

    def count(self) -> int:
        return max(0, self.until - self.start)


@runtime_checkable
class PartitionLog(Protocol):
    """Append-only offset-addressed log: the storage unit behind one
    (topic, partition). ``append`` returns the record's offset; ``read``
    returns records in ``[start, min(until, end))``; offsets are dense from 0.
    Implementations must be thread-safe (one broker serves many producer and
    consumer threads)."""

    def append(self, key: bytes | None, value: Any, timestamp: float) -> int: ...

    def read(self, start: int, until: int) -> list[Record]: ...

    def end_offset(self) -> int: ...


class InMemoryPartitionLog:
    """Default :class:`PartitionLog`: a locked Python list (single host)."""

    def __init__(self) -> None:
        self._records: list[Record] = []
        self._lock = new_lock("InMemoryPartitionLog._lock")

    def append(self, key: bytes | None, value: Any, timestamp: float) -> int:
        with self._lock:
            offset = len(self._records)
            self._records.append(Record(key, value, offset, timestamp))
            return offset

    def read(self, start: int, until: int) -> list[Record]:
        with self._lock:
            return self._records[start:min(until, len(self._records))]

    def end_offset(self) -> int:
        with self._lock:
            return len(self._records)


def _route_partition(key: Any, partitions: int) -> int:
    """Key -> partition. Bytes keys route by CRC-32, which is *stable across
    processes and restarts* — Python's hash() is salted per process, and with
    a durable log a salted route would strand a key's replayed history on a
    different partition than its new records."""
    if key is None:
        return 0
    if isinstance(key, (bytes, bytearray, memoryview)):
        return zlib.crc32(bytes(key)) % partitions
    return hash(key) % partitions


def _factory_wants_location(factory: Callable) -> bool:
    """Does ``factory`` accept ``(topic=, partition=)``? Durable logs need to
    know *which* partition they store (their directory is derived from it);
    zero-arg factories like :class:`InMemoryPartitionLog` don't."""
    try:
        inspect.signature(factory).bind(topic="", partition=0)
        return True
    except (TypeError, ValueError):
        return False


class Broker:
    """Topics → partitions → append-only :class:`PartitionLog` s, plus
    committed offsets per consumer group. Thread-safe.

    ``log_factory`` picks the storage per partition
    (:class:`InMemoryPartitionLog` unless told otherwise). A factory may be
    zero-argument, or accept ``(topic, partition)`` keywords — the broker
    passes the location to factories that want it, which is how
    :class:`~repro_torch.data.durable_log.DurableLogFactory` maps partitions
    onto stable directories that survive a restart."""

    def __init__(self, log_factory: Callable[..., PartitionLog] | None = None,
                 commit_topic: str | None = None, writable: bool = True,
                 epoch: int = 0) -> None:
        self._log_factory: Callable[..., PartitionLog] = (
            log_factory or InMemoryPartitionLog)
        self._locate_logs = _factory_wants_location(self._log_factory)
        self._topics: dict[str, list[PartitionLog]] = {}
        # topic -> payload codec name (repro_torch.data.codec); absent = raw
        self._topic_codecs: dict[str, str] = {}
        # topic -> group -> per-partition committed offsets
        self._committed: dict[str, dict[str, list[int]]] = {}
        self._lock = new_lock("Broker._lock")
        self._coordinator: Any = None
        self._coord_lock = new_lock("Broker._coord_lock")
        # -- HA role (repro_torch.data.replication) ------------------------
        # epoch is the fencing token: each failover promotes at a strictly
        # higher epoch, and a broker fenced by a higher epoch refuses writes
        self.epoch = epoch
        self.writable = writable           # False = replica until promoted
        self._fenced_by: int | None = None
        self.commit_topic = commit_topic
        self._commit_replay = False        # True while restore_commits runs
        # replica_id -> {topic: [per-partition replicated high-watermarks]}
        self._replica_hwms: dict[str, dict[str, list[int]]] = {}
        # runs after a successful promote (ReplicaFollower persists the new
        # epoch) — called outside the lock, with the broker
        self.on_promote: Callable[["Broker"], None] | None = None
        # instruments cached per topic: one dict lookup per produce/read,
        # no registry lookup on the hot path
        self._registry = get_registry()
        self._m_produce: dict[str, Any] = {}
        self._m_read: dict[str, Any] = {}

    def _register_topic_metrics(self, topic: str,
                                logs: list[PartitionLog]) -> None:
        self._m_produce[topic] = self._registry.counter(
            "broker_produce_records_total",
            "records appended to broker topics", labels={"topic": topic})
        self._m_read[topic] = self._registry.counter(
            "broker_read_records_total",
            "records read out of broker topics", labels={"topic": topic})
        self._registry.gauge(
            "broker_log_records", "per-topic log size (sum of end offsets)",
            labels={"topic": topic},
            callback=lambda: sum(log.end_offset() for log in logs))
        self._registry.gauge(
            "broker_lag", "produced-but-uncommitted records per topic",
            labels={"topic": topic}, callback=lambda: self.lag(topic))

    def _new_log(self, topic: str, partition: int) -> PartitionLog:
        if self._locate_logs:
            return self._log_factory(topic=topic, partition=partition)
        return self._log_factory()

    def create_topic(self, topic: str, partitions: int = 1,
                     codec: str | None = None) -> None:
        if partitions < 1:
            raise ValueError(f"topic {topic!r} needs at least one partition")
        if codec is not None:
            # validate the name now: a typo'd codec must fail topic
            # creation, not the first decode. Imported here, not at the top:
            # the codec module imports the transport, which imports this one
            from repro_torch.data.codec import get_codec
            codec = get_codec(codec).name
        with self._lock:
            if topic in self._topics:
                raise ValueError(f"topic {topic!r} exists")
            logs = [self._new_log(topic, p) for p in range(partitions)]
            self._topics[topic] = logs
            self._committed[topic] = {DEFAULT_GROUP: [0] * partitions}
            if codec is not None:
                self._topic_codecs[topic] = codec
        self._register_topic_metrics(topic, logs)

    def topic_codec(self, topic: str) -> str | None:
        """The payload codec this topic was created with (``None`` = raw).
        Advisory: producers (``IngestRunner``) encode values at the
        source→broker boundary, consumers decode at subscribe — the broker
        itself never looks inside a value."""
        self._topic(topic)             # raise KeyError for unknown topics
        with self._lock:
            return self._topic_codecs.get(topic)

    def topics(self) -> list[str]:
        with self._lock:
            return sorted(self._topics)

    def num_partitions(self, topic: str) -> int:
        return len(self._topic(topic))

    def _topic(self, topic: str) -> list[PartitionLog]:
        with self._lock:
            if topic not in self._topics:
                raise KeyError(f"unknown topic {topic!r}")
            return self._topics[topic]

    def _partition(self, topic: str, partition: int) -> PartitionLog:
        logs = self._topic(topic)
        if not 0 <= partition < len(logs):
            raise ValueError(
                f"partition {partition} out of range for topic {topic!r} "
                f"({len(logs)} partitions)")
        return logs[partition]

    # -- HA role ----------------------------------------------------------
    def _require_writable(self) -> None:
        if self._fenced_by is not None:
            raise BrokerFencedError(
                f"broker fenced by epoch {self._fenced_by} (own epoch "
                f"{self.epoch}): a promoted follower owns the log now")
        if not self.writable:
            raise NotPrimaryError(
                f"broker is a replica at epoch {self.epoch}; "
                "produce/commit must go to the primary")

    def broker_epoch(self) -> dict:
        """The fencing state clients probe before trusting a broker."""
        return {"epoch": self.epoch,
                "writable": self.writable and self._fenced_by is None}

    def fence(self, epoch: int) -> dict:
        """Fence this broker out of the write path: a failover promoted a
        follower at ``epoch``, so any write accepted here would fork the
        log. Requires a *strictly higher* epoch — a stale fencing attempt
        (epoch <= ours) is itself rejected."""
        if epoch <= self.epoch:
            raise ValueError(
                f"fence epoch {epoch} is not newer than broker epoch "
                f"{self.epoch}")
        with self._lock:
            if self._fenced_by is None or epoch > self._fenced_by:
                self._fenced_by = epoch
        return self.broker_epoch()

    def promote(self, epoch: int) -> dict:
        """Promote this (replica) broker to primary at ``epoch``.

        Idempotent across racing clients: the first caller at a new epoch
        performs the promotion (un-fence, then rebuild group/committed
        offsets from the replicated commit topic); later callers at the same
        or an older epoch get the current state back with
        ``promoted=False``. A promotion epoch must be strictly higher than
        the epoch this broker last followed, served or was fenced at, so a
        zombie primary can never promote itself back over the new one."""
        with self._lock:
            if self.writable and self._fenced_by is None \
                    and self.epoch >= epoch:
                return {"epoch": self.epoch, "promoted": False,
                        "writable": True}
            # the fence epoch is a floor too: a broker fenced at N knows a
            # promotion at N happened elsewhere, so re-entering at <= N
            # would put two primaries at the same epoch
            floor = max(self.epoch, self._fenced_by or 0)
            if epoch <= floor:
                raise ValueError(
                    f"promote epoch {epoch} is not newer than broker epoch "
                    f"{floor}")
            self.epoch = epoch
            self.writable = True
            self._fenced_by = None
        self.restore_commits()
        if self.on_promote is not None:
            self.on_promote(self)
        return {"epoch": epoch, "promoted": True, "writable": True}

    def fetch_frames(self, topic: str, partition: int, start: int,
                     max_bytes: int = 4 * 1024 * 1024
                     ) -> tuple[bytes, list[int], int, int]:
        """Replication pull: raw CRC frames for ``[start, end)`` of one
        partition as one contiguous blob plus per-frame sizes, capped at
        ``max_bytes`` a call. Returns ``(blob, lengths, next_offset,
        end_offset)``. Durable logs serve their segment bytes verbatim
        (:meth:`~repro_torch.data.durable_log.DurablePartitionLog
        .read_frames`); in-memory logs frame records on the fly, so every
        backend is replicable. The follower CRC-verifies every frame before
        it appends — the primary ships bytes, it does not re-check them."""
        plog = self._partition(topic, partition)
        end = plog.end_offset()
        reader = getattr(plog, "read_frames", None)
        if reader is not None:
            blob, lengths, nxt = reader(start, end, max_bytes=max_bytes)
            return blob, lengths, nxt, end
        # imported here: both modules import this one
        from repro_torch.data.durable_log import frame_bytes
        from repro_torch.data.transport import encode_message
        frames, total, nxt = [], 0, max(start, 0)
        for rec in plog.read(start, end):
            frame = frame_bytes(b"".join(
                encode_message((rec.key, rec.value, rec.timestamp))))
            if frames and total + len(frame) > max_bytes:
                break
            frames.append(frame)
            total += len(frame)
            nxt += 1
        return b"".join(frames), [len(f) for f in frames], nxt, end

    def replica_sync(self, replica_id: str, cursors: dict,
                     max_bytes: int = 4 * 1024 * 1024) -> dict:
        """One whole replication round in one round trip, so a follower
        does not tax the produce path it shares the broker with by polling
        ``topics``, each partition's :meth:`fetch_frames` and
        :meth:`replica_hwm` apart. ``cursors`` is the follower's ``{topic:
        [next_offset per partition]}``; it doubles as its high-watermark
        report (what the follower has is what is safely replicated).
        Returns ``{"topics": {topic: n_partitions}, "parts": {topic:
        [(blob, lengths, next_offset, end_offset), ...]}}``; topics the
        follower has no cursor for yet are served from offset 0 so it can
        mirror and append in the same round. ``max_bytes`` caps the payload
        across all partitions — the rest comes next round."""
        self.replica_hwm(replica_id, cursors)
        topics: dict[str, int] = {}
        parts: dict[str, list] = {}
        remaining = int(max_bytes)
        for topic in self.topics():
            plogs = self._topic(topic)
            topics[topic] = len(plogs)
            starts = cursors.get(topic) or []
            entries = []
            for p, plog in enumerate(plogs):
                start = int(starts[p]) if p < len(starts) else 0
                end = plog.end_offset()
                if remaining > 0 and start < end:
                    blob, lengths, nxt, end = self.fetch_frames(
                        topic, p, start, max_bytes=remaining)
                    remaining -= len(blob)
                else:
                    blob, lengths, nxt = b"", [], start
                entries.append((blob, lengths, nxt, end))
            parts[topic] = entries
        return {"topics": topics, "parts": parts}

    def replica_hwm(self, replica_id: str | None = None,
                    hwms: dict | None = None) -> dict:
        """Follower-reported replicated high-watermarks.

        A follower calls this with its ``replica_id`` and a ``{topic:
        [per-partition next offsets]}`` map after each pull round; anyone (a
        :class:`~repro_torch.data.replication.FailoverBroker` confirming
        its resend window) calls it bare to read the whole ``{replica_id:
        {topic: [hwm]}}`` map back."""
        with self._lock:
            if replica_id is not None and hwms is not None:
                self._replica_hwms[str(replica_id)] = {
                    str(t): [int(o) for o in offs]
                    for t, offs in hwms.items()}
            return {r: {t: list(offs) for t, offs in m.items()}
                    for r, m in self._replica_hwms.items()}

    def _record_group_event(self, event: tuple) -> None:
        """Append one commit/generation event to the commit topic (when
        configured) so group progress survives a failover. Never on the
        replay path, and never for the commit topic itself."""
        if self.commit_topic is None or self._commit_replay:
            return
        with self._lock:
            missing = self.commit_topic not in self._topics
        if missing:
            self.create_topic(self.commit_topic, 1)
        self._topic(self.commit_topic)[0].append(None, event, 0.0)
        self._m_produce[self.commit_topic].inc()

    def restore_commits(self) -> int:
        """Replay the commit topic into per-group committed offsets and the
        coordinator's generation floor — the restart and promotion path
        (data topics are restored by ``DurableLogFactory.restore``).
        Offsets are clamped to the local log end: replication of the data
        may trail replication of the commit record, and a committed offset
        past the log would wedge every reader. Returns the number of events
        applied."""
        if self.commit_topic is None:
            return 0
        with self._lock:
            if self.commit_topic not in self._topics:
                return 0
        plog = self._topic(self.commit_topic)[0]
        applied = 0
        self._commit_replay = True
        try:
            for rec in plog.read(0, plog.end_offset()):
                event = tuple(rec.value)
                if event[0] == "commit":
                    _, group, topic, partition, offset = event
                    try:
                        logs = self._topic(topic)
                    except KeyError:
                        continue           # data topic not replicated (yet)
                    if not 0 <= int(partition) < len(logs):
                        continue
                    offset = min(int(offset),
                                 logs[int(partition)].end_offset())
                    with self._lock:
                        done = self._committed[topic].setdefault(
                            str(group), [0] * len(logs))
                        if len(done) < len(logs):
                            done.extend([0] * (len(logs) - len(done)))
                        done[int(partition)] = max(done[int(partition)],
                                                   offset)
                elif event[0] == "gen":
                    _, group, generation = event
                    self.coordinator.seed_generation(str(group),
                                                     int(generation))
                applied += 1
        finally:
            self._commit_replay = False
        return applied

    # -- producer ---------------------------------------------------------
    def produce(self, topic: str, value: Any, key: bytes | None = None,
                partition: int | None = None, timestamp: float = 0.0) -> int:
        self._require_writable()
        logs = self._topic(topic)
        if partition is None:
            partition = _route_partition(key, len(logs))
        offset = self._partition(topic, partition).append(key, value,
                                                          timestamp)
        self._m_produce[topic].inc()
        return offset

    def produce_many(self, topic: str, pairs: Sequence[tuple],
                     partition: int | None = None, timestamp: float = 0.0
                     ) -> list[int]:
        """Append a batch of ``(key, value)`` pairs; returns their offsets in
        input order.

        Validation is all-or-nothing: an unknown topic, an out-of-range
        ``partition``, a malformed pair or an unroutable key raises *before
        any record is appended*. With ``partition=None`` each pair routes by
        its key (:func:`_route_partition`). With an explicit ``partition``,
        a log with ``append_many`` (the durable log) takes the whole batch
        in one call: one write and at most one fsync."""
        self._require_writable()
        logs = self._topic(topic)
        if partition is not None:
            self._partition(topic, partition)
        batch = []
        for pair in pairs:
            try:
                key, value = pair
            except (TypeError, ValueError):
                raise ValueError(
                    f"produce_many pair must be (key, value), got {pair!r}")
            if partition is None:
                try:
                    p = _route_partition(key, len(logs))
                except TypeError:          # unhashable non-bytes key: fail
                    raise ValueError(      # the batch BEFORE any append
                        f"produce_many key {key!r} is not routable "
                        "(unhashable); pass an explicit partition")
            else:
                p = partition
            batch.append((key, value, p))
        if partition is not None:
            append_many = getattr(logs[partition], "append_many", None)
            if append_many is not None:
                offsets = list(append_many([(k, v) for k, v, _ in batch],
                                           timestamp))
                self._m_produce[topic].inc(len(offsets))
                return offsets
        offsets = [logs[p].append(k, v, timestamp) for k, v, p in batch]
        self._m_produce[topic].inc(len(offsets))
        return offsets

    # -- consumer ---------------------------------------------------------
    def read(self, rng: OffsetRange) -> list[Record]:
        records = self._partition(rng.topic, rng.partition).read(rng.start,
                                                                 rng.until)
        if records:
            self._m_read[rng.topic].inc(len(records))
        return records

    def end_offset(self, topic: str, partition: int = 0) -> int:
        return self._partition(topic, partition).end_offset()

    def end_offsets(self, topic: str) -> list[int]:
        return [log.end_offset() for log in self._topic(topic)]

    # -- consumer progress -------------------------------------------------
    # Committed offsets live broker-side so producers in other processes can
    # bound their lag against what the consumer has processed. Commits are
    # monotonic: replays never move progress backwards. Each consumer group
    # tracks its own offsets; groupless callers share ``DEFAULT_GROUP``.
    def commit(self, topic: str, partition: int, offset: int,
               group: str = DEFAULT_GROUP, consumer: str | None = None,
               generation: int | None = None) -> None:
        # network-facing via the transport: a bad partition (negative Python
        # indexing) or an offset past the log end must not poison the lag
        # signal backpressure runs on
        self._require_writable()
        logs = self._topic(topic)
        if not 0 <= partition < len(logs):
            raise ValueError(
                f"partition {partition} out of range for topic {topic!r} "
                f"({len(logs)} partitions)")
        if not 0 <= offset <= logs[partition].end_offset():
            raise ValueError(
                f"commit offset {offset} outside "
                f"[0, {logs[partition].end_offset()}] for "
                f"{topic!r}[{partition}]")
        if generation is not None:
            # generation fencing: only a live member of `group` at the
            # current generation that owns the partition may advance it — a
            # zombie consumer's commit raises StaleGenerationError instead
            # of corrupting the group's lag signal. Checked before taking
            # self._lock (coordinator -> broker lock order).
            self.coordinator.check_commit(group, consumer, generation,
                                          topic=topic, partition=partition)
        with self._lock:
            done = self._committed[topic].setdefault(group, [0] * len(logs))
            if len(done) < len(logs):
                done.extend([0] * (len(logs) - len(done)))
            advanced = offset > done[partition]
            done[partition] = max(done[partition], offset)
        if advanced and topic != self.commit_topic:
            # the durable (and so replicated) record of the advance: one
            # append a committing micro-batch, the price of group progress
            # surviving a broker failover (see restore_commits)
            self._record_group_event(("commit", group, topic, partition,
                                      offset))

    def committed(self, topic: str, group: str = DEFAULT_GROUP) -> list[int]:
        logs = self._topic(topic)
        with self._lock:
            done = self._committed[topic].get(group)
            if done is None:
                return [0] * len(logs)
            return done + [0] * (len(logs) - len(done))

    def commit_groups(self, topic: str) -> list[str]:
        """Groups with committed offsets on ``topic`` (default group first)."""
        self._topic(topic)
        with self._lock:
            return sorted(self._committed[topic])

    def lag(self, topic: str, group: str = DEFAULT_GROUP) -> int:
        """Produced-but-uncommitted records — the backpressure signal,
        measured against ``group``'s committed offsets."""
        return sum(self.end_offsets(topic)) - sum(self.committed(topic,
                                                                 group))

    # -- consumer groups ---------------------------------------------------
    @property
    def coordinator(self):
        """The broker-hosted :class:`~repro_torch.data.groups
        .GroupCoordinator`, created on first use. Tests install a
        fake-clock coordinator by assigning ``broker._coordinator`` before
        the first group op."""
        with self._coord_lock:
            if self._coordinator is None:
                # imported here: the groups module imports the transport,
                # which imports this one
                from repro_torch.data.groups import GroupCoordinator
                self._coordinator = GroupCoordinator(self)
            return self._coordinator

    def join_group(self, group: str, consumer: str, topics: Sequence[str],
                   session_timeout: float = 5.0) -> dict:
        # group membership is primary-side state: joining a fenced zombie or
        # an unpromoted replica would split the group across brokers
        self._require_writable()
        return self.coordinator.join_group(group, consumer, topics,
                                           session_timeout=session_timeout)

    def heartbeat(self, group: str, consumer: str, generation: int) -> dict:
        return self.coordinator.heartbeat(group, consumer, generation)

    def sync_group(self, group: str, consumer: str,
                   generation: int) -> dict:
        return self.coordinator.sync_group(group, consumer, generation)

    def leave_group(self, group: str, consumer: str) -> None:
        return self.coordinator.leave_group(group, consumer)

    def describe_group(self, group: str) -> dict:
        return self.coordinator.describe(group)


def create_rdd(context: Context, broker: Broker,
               offset_ranges: Sequence[OffsetRange],
               value_decoder: Callable[[Any], Any] | None = None) -> RDD:
    """``KafkaUtils.createRDD`` — one RDD partition per OffsetRange.

    The read happens lazily inside the partition, so a recomputed partition
    re-reads the broker at the same offsets (Kafka's replayability).
    ``value_decoder`` runs on every value read (the codec decode, then the
    subscriber's own)."""
    ranges = list(offset_ranges)

    def compute(idx: int) -> list[Any]:
        values = [r.value for r in broker.read(ranges[idx])]
        if value_decoder is not None:
            values = [value_decoder(v) for v in values]
        return values

    return RDD(context, len(ranges), [], compute, name="kafkaRDD")
