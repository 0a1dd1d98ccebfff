"""An in-process message broker with Kafka semantics (paper §II, Fig. 7-8),
trimmed to what the streaming path uses.

The counterpart of ``repro/core/broker.py``: topics split into partitions,
each partition an append-only, totally ordered log addressed by offsets,
with no order across partitions; records are (key, value) pairs.
:func:`create_rdd` is ``KafkaUtils.createRDD``: one RDD partition per
explicit ``OffsetRange`` read. The broker also keeps the offsets its
consumer committed.

Storage sits behind the :class:`PartitionLog` protocol
(``append``/``read``/``end_offset``, plus an optional ``append_many`` for
the batched :meth:`Broker.produce_many`): :class:`Broker` composes one log
per (topic, partition) from its ``log_factory`` and never looks inside.
:class:`InMemoryPartitionLog` is the default;
:class:`~repro_torch.data.durable_log.DurablePartitionLog` keeps the log on
disk across restarts, and ``DurableLogFactory.restore(broker)`` reopens
every topic it finds. Locks come from :mod:`repro_torch.data.locktrace`.
Fencing, replication, consumer groups, codecs and the metrics registry of
the reference are left out (ROADMAP Queue 1 items 3.4, 3.6 and 3.7).
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Any, Callable, Protocol, Sequence, runtime_checkable

from repro_torch.core.rdd import RDD, Context
from repro_torch.data.locktrace import new_lock


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
    committed offsets. Thread-safe.

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
        self._committed: dict[str, list[int]] = {}
        self._lock = new_lock("Broker._lock")

    def _new_log(self, topic: str, partition: int) -> PartitionLog:
        if self._locate_logs:
            return self._log_factory(topic=topic, partition=partition)
        return self._log_factory()

    def create_topic(self, topic: str, partitions: int = 1) -> None:
        if partitions < 1:
            raise ValueError(f"topic {topic!r} needs at least one partition")
        with self._lock:
            if topic in self._topics:
                raise ValueError(f"topic {topic!r} exists")
            self._topics[topic] = [self._new_log(topic, p)
                                   for p in range(partitions)]
            self._committed[topic] = [0] * partitions

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
                partition: int = 0, timestamp: float = 0.0) -> int:
        return self._partition(topic, partition).append(key, value, timestamp)

    def produce_many(self, topic: str, pairs: Sequence[tuple],
                     partition: int = 0, timestamp: float = 0.0
                     ) -> list[int]:
        """Append ``(key, value)`` pairs to one partition; returns their
        offsets in input order. A malformed pair raises before any record
        is appended. A log with ``append_many`` (the durable log) takes the
        whole batch in one call: one write and at most one fsync."""
        plog = self._partition(topic, partition)
        batch = []
        for pair in pairs:
            try:
                key, value = pair
            except (TypeError, ValueError):
                raise ValueError(
                    f"produce_many pair must be (key, value), got {pair!r}")
            batch.append((key, value))
        append_many = getattr(plog, "append_many", None)
        if append_many is not None:
            return list(append_many(batch, timestamp))
        return [plog.append(k, v, timestamp) for k, v in batch]

    # -- consumer ---------------------------------------------------------
    def read(self, rng: OffsetRange) -> list[Record]:
        return self._partition(rng.topic, rng.partition).read(rng.start,
                                                              rng.until)

    def end_offset(self, topic: str, partition: int = 0) -> int:
        return self._partition(topic, partition).end_offset()

    def end_offsets(self, topic: str) -> list[int]:
        return [log.end_offset() for log in self._topic(topic)]

    # -- consumer progress -------------------------------------------------
    def commit(self, topic: str, partition: int, offset: int) -> None:
        """Record that the consumer processed ``topic[partition]`` up to
        ``offset``. Commits are monotonic: a replay never moves them back."""
        plog = self._partition(topic, partition)
        if not 0 <= offset <= plog.end_offset():
            raise ValueError(
                f"commit offset {offset} outside [0, {plog.end_offset()}] "
                f"for {topic!r}[{partition}]")
        with self._lock:
            done = self._committed[topic]
            done[partition] = max(done[partition], offset)

    def committed(self, topic: str) -> list[int]:
        self._topic(topic)                    # raise on unknown topic
        with self._lock:
            return list(self._committed[topic])


def create_rdd(context: Context, broker: Broker,
               offset_ranges: Sequence[OffsetRange]) -> RDD:
    """``KafkaUtils.createRDD`` — one RDD partition per OffsetRange.

    The read happens lazily inside the partition, so a recomputed partition
    re-reads the broker at the same offsets (Kafka's replayability)."""
    ranges = list(offset_ranges)

    def compute(idx: int) -> list[Any]:
        return [r.value for r in broker.read(ranges[idx])]

    return RDD(context, len(ranges), compute)
