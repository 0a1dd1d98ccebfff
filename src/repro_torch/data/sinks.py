"""Sinks: where micro-batch results go (paper Fig. 7's right-hand side —
visualization, storage, downstream topics).

The counterpart of ``repro/data/sinks.py``. The stream gives at-least-once
delivery: a batch whose sink failed is replayed at the same offsets. Keyed
sinks are idempotent by key — an item written twice is skipped the second
time — which upgrades that to exactly-once. ``write_batch`` is the one entry
point; a sink may be written serially in the batch thread or from its own
delivery lane (:mod:`repro_torch.data.delivery`), so every counter a sink
keeps is guarded by its lock.
"""
from __future__ import annotations

import os
import threading
from typing import (Any, Callable, Iterable, Protocol, Sequence,
                    runtime_checkable)

import numpy as np

from repro_torch.core.broker import Broker
from repro_torch.data.metrics import span

KeyedItem = tuple[str, Any]


@runtime_checkable
class Sink(Protocol):
    """Batch-oriented keyed sink. Returns the number of items actually
    written (duplicates skipped — idempotence is part of the contract)."""

    def write_batch(self, items: Sequence[KeyedItem]) -> int: ...

    def close(self) -> None: ...


def describe_result_items(result: Any, batch_index: int) -> list[KeyedItem]:
    """Normalize a batch result into keyed items for a sink.

    A list of ``(key, value)`` pairs (keys str or bytes) passes through;
    ``None`` produces nothing; any other value becomes one item keyed by the
    batch index, so replaying the batch overwrites rather than duplicates.
    """
    if result is None:
        return []
    if isinstance(result, list) and all(
            isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], (str, bytes)) for x in result):
        return [(k.decode() if isinstance(k, bytes) else k, v)
                for k, v in result]
    return [(f"batch-{batch_index:06d}", result)]


class KeyedSink:
    """Base: in-process dedupe by key. Subclasses implement ``_write_one``;
    ``_already_stored`` lets a subclass extend idempotence across restarts
    (e.g. files on disk)."""

    def __init__(self) -> None:
        self._seen: set[str] = set()
        self._lock = threading.Lock()
        self.written = 0
        self.skipped = 0

    def _write_one(self, key: str, value: Any) -> None:  # pragma: no cover
        raise NotImplementedError

    def _already_stored(self, key: str) -> bool:
        return False

    def write_batch(self, items: Sequence[KeyedItem], *,
                    overwrite: bool = False) -> int:
        """``overwrite=True`` bypasses dedupe for keys that must track the
        latest run (e.g. a final-result artifact)."""
        n = 0
        for key, value in items:
            with self._lock:
                dup = (not overwrite
                       and (key in self._seen or self._already_stored(key)))
                self._seen.add(key)
                if dup:
                    self.skipped += 1
            if dup:
                continue
            # the write outside the lock: a slow _write_one must not
            # serialise other writers; the counter under it, since lanes
            # sharing a sink race on it
            self._write_one(key, value)
            with self._lock:
                self.written += 1
            n += 1
        return n

    def close(self) -> None:
        pass


class NpzDirectorySink(KeyedSink):
    """Artifact store: one ``<key>.npz`` per item under ``directory``.
    Values may be an array, a dict of arrays, or a scalar. Idempotent across
    restarts: an existing file is never rewritten. Each write is the span
    ``npz_write``, its flush and fsync the span ``fsync`` inside it."""

    def __init__(self, directory: str) -> None:
        super().__init__()
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def path_for(self, key: str) -> str:
        safe = key.replace(os.sep, "_")
        return os.path.join(self.directory, f"{safe}.npz")

    def _already_stored(self, key: str) -> bool:
        return os.path.exists(self.path_for(key))

    def _write_one(self, key: str, value: Any) -> None:
        with span("npz_write"):
            arrays = (dict(value) if isinstance(value, dict)
                      else {"value": np.asarray(value)})
            arrays = {k: np.asarray(v) for k, v in arrays.items()}
            path = self.path_for(key)
            # write via an open handle: np.savez would append ".npz" to a
            # bare tmp name, and a ".tmp.npz" suffix would show up in
            # keys_on_disk() after a crash before the rename
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
                # flush+fsync before the rename, or a crash can leave
                # `path` naming torn bytes — and _already_stored would
                # then skip the rewrite forever
                with span("fsync"):
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, path)

    def keys_on_disk(self) -> list[str]:
        return sorted(f[:-4] for f in os.listdir(self.directory)
                      if f.endswith(".npz"))


class TopicSink(KeyedSink):
    """Pipe results into a downstream broker topic — the paper's multi-stage
    pipelines: this topic is the next stage's input."""

    def __init__(self, broker: Broker, topic: str, partitions: int = 1) -> None:
        super().__init__()
        self.broker = broker
        self.topic = topic
        if topic not in broker.topics():
            broker.create_topic(topic, partitions)
        self._rr = 0

    def _write_one(self, key: str, value: Any) -> None:
        n = self.broker.num_partitions(self.topic)
        with self._lock:
            partition = self._rr % n
            self._rr += 1
        self.broker.produce(self.topic, value, key=key.encode(),
                            partition=partition)


class CallbackSink(KeyedSink):
    """Hand each new ``(key, value)`` to a callable (live plots, asserts)."""

    def __init__(self, fn: Callable[[str, Any], None]) -> None:
        super().__init__()
        self._fn = fn

    def _write_one(self, key: str, value: Any) -> None:
        self._fn(key, value)


class MetricsSink:
    """Latency/throughput aggregation over batches. ``observe(info)`` takes
    each :class:`~repro_torch.core.dstream.BatchInfo`; ``write_batch`` counts
    keyed items, so it sits next to a storage sink."""

    def __init__(self) -> None:
        # both surfaces may be called from different threads; one lock keeps
        # the counters and the report() snapshot consistent
        self._lock = threading.Lock()
        self.batches = 0
        self.records = 0
        self.items = 0
        self.latencies: list[float] = []

    def observe(self, info: Any) -> None:
        with self._lock:
            self.batches += 1
            self.records += info.num_records
            self.latencies.append(info.processing_time)

    def write_batch(self, items: Sequence[KeyedItem]) -> int:
        with self._lock:
            self.items += len(items)
        return 0

    def close(self) -> None:
        pass

    def report(self) -> dict[str, float]:
        with self._lock:
            batches, records, items = self.batches, self.records, self.items
            latencies = list(self.latencies)
        if not latencies:
            return {"batches": batches, "records": records, "items": items}
        total = max(sum(latencies), 1e-9)
        return {
            "batches": batches,
            "records": records,
            "items": items,
            "mean_latency_s": sum(latencies) / len(latencies),
            "max_latency_s": max(latencies),
            "throughput_rec_per_s": records / total,
        }


def fan_out(sinks: Iterable[Sink]) -> Callable[[Sequence[KeyedItem]], int]:
    """Write the same items to several sinks; returns total writes."""
    sinks = list(sinks)

    def write(items: Sequence[KeyedItem]) -> int:
        return sum(s.write_batch(items) for s in sinks)

    return write
