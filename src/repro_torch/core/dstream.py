"""Discretized streams: micro-batch scheduling over RDDs (paper §II, Fig. 7),
trimmed to what the streaming path uses.

The counterpart of ``repro/core/dstream.py``. Each micro-batch pumps the
subscribed sources into their broker topics, reads what each topic
partition holds past the consumed offsets (capped per partition) into a
per-topic RDD, unions them, applies the pipeline function and hands the
result to the serial sinks. Sinks run *before* the commit: a raising sink
leaves the offsets where they were and the batch replays (at-least-once,
exactly-once with the idempotent keyed sinks). Consumer groups, delivery
lanes, trace spans, the observability server and the offset checkpoint file
of the reference are left out; progress lives in memory and broker-side.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Sequence

from repro_torch.core.broker import Broker, OffsetRange, create_rdd
from repro_torch.core.rdd import RDD, Context


@dataclass
class BatchInfo:
    index: int
    ranges: list[OffsetRange]
    num_records: int
    processing_time: float = 0.0
    result: Any = None


class StreamingContext:
    """Drives micro-batches: broker topics -> union RDD -> pipeline fn -> sinks."""

    def __init__(self, context: Context, broker: Broker,
                 max_records_per_partition: int | None = None, *,
                 batch_interval: float = 0.1) -> None:
        self.context = context
        self.broker = broker
        self.batch_interval = batch_interval
        self.max_records_per_partition = max_records_per_partition
        self._topics: list[str] = []
        self._batch_fn: Callable[[RDD, BatchInfo], Any] | None = None
        self._sinks: list[Callable[[BatchInfo], None]] = []
        # pull-model sources pumped before each micro-batch:
        # (source, topic, records per pump)
        self._sources: list[tuple[Any, str, int]] = []
        # per-topic produce round-robin cursor, kept across batches so short
        # polls do not restart at partition 0 every batch
        self._rr: dict[str, int] = {}
        self._offsets: dict[str, list[int]] = {}   # consumed, per partition
        self._history: list[BatchInfo] = []
        self._batch_index = 0

    # -- wiring -------------------------------------------------------------
    def subscribe(self, topics: Sequence[str]) -> None:
        self._topics.extend(t for t in topics if t not in self._topics)

    def subscribe_source(self, source: Any, topic: str | None = None,
                         partitions: int = 1) -> str:
        """Subscribe a :class:`repro_torch.data.sources.SequenceSource`:
        create ``topic`` if missing (default ``source-<i>``), subscribe to
        it, and pump the source before each micro-batch. A replayable
        source is ``seek``-ed to the topic's end, so records the broker
        already has are not produced again."""
        topic = topic or f"source-{len(self._sources)}"
        if topic not in self.broker.topics():
            self.broker.create_topic(topic, partitions)
        if hasattr(source, "seek"):
            source.seek(sum(self.broker.end_offsets(topic)))
        self.subscribe([topic])
        if self.max_records_per_partition is not None:
            # the consumer cap is per partition; pump enough to fill them all
            n = self.max_records_per_partition * partitions
        else:
            n = 64
        self._sources.append((source, topic, n))
        return topic

    def foreach_batch(self, fn: Callable[[RDD, BatchInfo], Any]) -> None:
        self._batch_fn = fn

    def add_sink(self, fn: Callable[[BatchInfo], None]) -> None:
        """Register a serial batch sink, run in the batch thread before the
        commit."""
        self._sinks.append(fn)

    # -- consumer-side accounting ------------------------------------------
    def _consumed(self, topic: str, parts: int) -> list[int]:
        starts = self._offsets.setdefault(topic, [])
        starts.extend([0] * (parts - len(starts)))
        return starts

    def committed(self, topic: str) -> int:
        """Total records committed (processed) for a topic."""
        return sum(self._offsets.get(topic, []))

    @property
    def sources_exhausted(self) -> bool:
        return all(s.exhausted for s, _, _ in self._sources)

    @property
    def history(self) -> list[BatchInfo]:
        return self._history

    # -- one micro-batch ------------------------------------------------------
    def _pending_ranges(self) -> list[OffsetRange]:
        ranges: list[OffsetRange] = []
        cap = self.max_records_per_partition
        for topic in self._topics:
            ends = self.broker.end_offsets(topic)
            starts = self._consumed(topic, len(ends))
            for p, (start, end) in enumerate(zip(starts, ends)):
                if cap is not None:
                    end = min(end, start + cap)
                if end > start:
                    ranges.append(OffsetRange(topic, p, start, end))
        return ranges

    def _pump_sources(self) -> None:
        for source, topic, n in self._sources:
            if source.exhausted:
                continue
            parts = self.broker.num_partitions(topic)
            rr = self._rr.get(topic, 0)
            for key, value in source.poll(n):
                self.broker.produce(topic, value, key=key,
                                    partition=rr % parts,
                                    timestamp=time.monotonic())
                rr += 1
            self._rr[topic] = rr

    def run_one_batch(self) -> BatchInfo | None:
        """Paper Fig. 8 ``run_batch``: per-topic RDDs, union, process."""
        self._pump_sources()
        ranges = self._pending_ranges()
        if not ranges:
            return None
        info = BatchInfo(index=self._batch_index, ranges=ranges,
                         num_records=sum(r.count() for r in ranges))
        per_topic: dict[str, list[OffsetRange]] = {}
        for r in ranges:
            per_topic.setdefault(r.topic, []).append(r)
        topic_rdds = [create_rdd(self.context, self.broker, rs)
                      for rs in per_topic.values()]
        union = topic_rdds[0].union(*topic_rdds[1:])
        t0 = time.perf_counter()
        if self._batch_fn is not None:
            info.result = self._batch_fn(union, info)
        info.processing_time = time.perf_counter() - t0
        # Serial sinks run BEFORE the commit: a raising sink aborts it and
        # the batch replays at the same offsets.
        for sink in self._sinks:
            sink(info)
        self._commit(ranges)
        self._batch_index += 1
        self._history.append(info)
        return info

    def _commit(self, ranges: Sequence[OffsetRange]) -> None:
        """Advance the consumed offsets, here and broker-side."""
        for r in ranges:
            self._offsets[r.topic][r.partition] = r.until
            self.broker.commit(r.topic, r.partition, r.until)

    # -- near-real-time accounting ------------------------------------------
    def realtime_report(self) -> dict[str, float]:
        """Is processing keeping up with the batch interval? (paper §III).
        The keys and values of ``repro/core/dstream.py:realtime_report``."""
        if not self._history:
            return {"batches": 0}
        times = [b.processing_time for b in self._history]
        recs = sum(b.num_records for b in self._history)
        return {
            "batches": len(self._history),
            "records": recs,
            "mean_processing_s": sum(times) / len(times),
            "max_processing_s": max(times),
            "throughput_rec_per_s": recs / max(sum(times), 1e-9),
            "keeps_up": max(times) <= self.batch_interval,
        }
