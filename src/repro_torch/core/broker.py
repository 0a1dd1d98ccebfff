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

The reference's generation fencing through the group coordinator (ROADMAP
Queue 1 item 3.6) and its replication, HA role and commit topic (item 3.7)
are left out: a commit that names a ``generation`` raises
``NotImplementedError``.
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

    def __init__(self, log_factory: Callable[..., PartitionLog] | None = None
                 ) -> None:
        self._log_factory: Callable[..., PartitionLog] = (
            log_factory or InMemoryPartitionLog)
        self._locate_logs = _factory_wants_location(self._log_factory)
        self._topics: dict[str, list[PartitionLog]] = {}
        # topic -> payload codec name (repro_torch.data.codec); absent = raw
        self._topic_codecs: dict[str, str] = {}
        # topic -> group -> per-partition committed offsets
        self._committed: dict[str, dict[str, list[int]]] = {}
        self._lock = new_lock("Broker._lock")
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

    # -- producer ---------------------------------------------------------
    def produce(self, topic: str, value: Any, key: bytes | None = None,
                partition: int | None = None, timestamp: float = 0.0) -> int:
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
            raise NotImplementedError(
                "generation-fenced commits need the group coordinator, "
                "ROADMAP Queue 1 item 3.6")
        with self._lock:
            done = self._committed[topic].setdefault(group, [0] * len(logs))
            if len(done) < len(logs):
                done.extend([0] * (len(logs) - len(done)))
            done[partition] = max(done[partition], offset)

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

    return RDD(context, len(ranges), compute)
