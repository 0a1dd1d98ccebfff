"""An in-process message broker with Kafka semantics (paper §II, Fig. 7-8),
trimmed to what the streaming path uses.

The counterpart of ``repro/core/broker.py``: topics split into partitions,
each partition an append-only, totally ordered log addressed by offsets,
with no order across partitions; records are (key, value) pairs.
:func:`create_rdd` is ``KafkaUtils.createRDD``: one RDD partition per
explicit ``OffsetRange`` read. The broker also keeps the offsets its
consumer committed. Durable logs, fencing, replication, consumer groups,
codecs and the metrics registry of the reference are left out.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Sequence

from repro_torch.core.rdd import RDD, Context


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


class InMemoryPartitionLog:
    """One (topic, partition): a locked Python list."""

    def __init__(self) -> None:
        self._records: list[Record] = []
        self._lock = threading.Lock()

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


class Broker:
    """Topics → partitions → append-only logs, plus committed offsets.
    Thread-safe."""

    def __init__(self) -> None:
        self._topics: dict[str, list[InMemoryPartitionLog]] = {}
        self._committed: dict[str, list[int]] = {}
        self._lock = threading.Lock()

    def create_topic(self, topic: str, partitions: int = 1) -> None:
        if partitions < 1:
            raise ValueError(f"topic {topic!r} needs at least one partition")
        with self._lock:
            if topic in self._topics:
                raise ValueError(f"topic {topic!r} exists")
            self._topics[topic] = [InMemoryPartitionLog()
                                   for _ in range(partitions)]
            self._committed[topic] = [0] * partitions

    def topics(self) -> list[str]:
        with self._lock:
            return sorted(self._topics)

    def num_partitions(self, topic: str) -> int:
        return len(self._topic(topic))

    def _topic(self, topic: str) -> list[InMemoryPartitionLog]:
        with self._lock:
            if topic not in self._topics:
                raise KeyError(f"unknown topic {topic!r}")
            return self._topics[topic]

    def _partition(self, topic: str, partition: int) -> InMemoryPartitionLog:
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
        is appended."""
        plog = self._partition(topic, partition)
        batch = []
        for pair in pairs:
            try:
                key, value = pair
            except (TypeError, ValueError):
                raise ValueError(
                    f"produce_many pair must be (key, value), got {pair!r}")
            batch.append((key, value))
        return [plog.append(k, v, timestamp) for k, v in batch]

    # -- consumer ---------------------------------------------------------
    def read(self, rng: OffsetRange) -> list[Record]:
        return self._partition(rng.topic, rng.partition).read(rng.start,
                                                              rng.until)

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
