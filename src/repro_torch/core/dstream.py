"""Discretized streams: micro-batch scheduling over RDDs (paper §II, Fig. 7),
trimmed to what the streaming paths use.

The counterpart of ``repro/core/dstream.py``. Each micro-batch pumps the
subscribed sources into their broker topics, reads what each topic
partition holds past the consumed offsets (capped per partition) into a
per-topic RDD, unions them, applies the pipeline function and hands the
result to the sinks. Serial sinks run *before* the commit: a raising sink
leaves the offsets where they were and the batch replays (at-least-once,
exactly-once with the idempotent keyed sinks). Delivery *lanes*
(``add_sink(policy=...)``, :mod:`repro_torch.data.delivery`) are
asynchronous and keep their documented <= queue-depth post-commit crash
window.

With a ``checkpoint_path`` the progress survives a restart: the consumed
offsets go to an epoch-stamped :class:`StreamProgress` file after every
batch, *atomically with attached window state* (one ``os.replace``; see
``repro_torch/data/state.py``), so an open window's accumulated records
survive a crash together with the offsets that consumed them. Without one,
progress lives in memory and broker-side. Consumer groups, trace spans and
the observability server of the reference are left out (ROADMAP Queue 1
items 3.4 and 3.6).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from repro_torch.core.broker import Broker, OffsetRange, create_rdd
from repro_torch.core.rdd import RDD, Context
from repro_torch.data.delivery import DeliveryRuntime
from repro_torch.utils import get_logger

log = get_logger(__name__)


@dataclass
class BatchInfo:
    index: int
    ranges: list[OffsetRange]
    num_records: int
    scheduled_at: float = 0.0
    processing_time: float = 0.0
    result: Any = None


@dataclass
class StreamProgress:
    """The restart checkpoint, epoch-stamped: consumed offsets per (topic,
    partition) plus, per attached windower, the ref its state store returned
    for this epoch. One ``save`` is one ``os.replace`` — offsets and window
    state advance *together or not at all*."""
    offsets: dict[str, list[int]] = field(default_factory=dict)
    epoch: int = 0
    window_refs: dict[str, int] = field(default_factory=dict)

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"epoch": self.epoch, "offsets": self.offsets,
                       "window_refs": self.window_refs}, f)
            # fsync before the rename: os.replace is atomic against a crash,
            # but without it the new checkpoint's *contents* may not be on
            # disk when the rename is
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "StreamProgress":
        """Load a checkpoint; a torn/corrupt/old-format file degrades to an
        empty progress (with a warning) instead of making the restart
        unrecoverable — the stream replays from offset 0 and idempotent
        sinks absorb the duplicates (at-least-once, never stuck)."""
        if not os.path.exists(path):
            return cls()
        try:
            with open(path) as f:
                blob = json.load(f)
            offsets = {str(t): [int(o) for o in parts]
                       for t, parts in blob["offsets"].items()}
            return cls(offsets=offsets, epoch=int(blob.get("epoch", 0)),
                       window_refs={str(k): int(v) for k, v in
                                    blob.get("window_refs", {}).items()})
        except (OSError, ValueError, KeyError, TypeError,
                AttributeError) as exc:
            log.warning("checkpoint %s is unreadable (%s: %s); starting "
                        "from empty progress", path, type(exc).__name__, exc)
            return cls()


class StreamingContext:
    """Drives micro-batches: broker topics -> union RDD -> pipeline fn -> sinks."""

    def __init__(self, context: Context, broker: Broker,
                 batch_interval: float = 0.1,
                 max_records_per_partition: int | None = None,
                 checkpoint_path: str | None = None,
                 clock: Callable[[], float] | None = None) -> None:
        self.context = context
        self.broker = broker
        self.batch_interval = batch_interval
        self.max_records_per_partition = max_records_per_partition
        self.checkpoint_path = checkpoint_path
        # stream clock: stamps BatchInfo.scheduled_at and pumped-record
        # timestamps. Injectable so time windows are deterministic in tests
        self._default_clock = clock is None
        self._clock = clock or time.monotonic
        self._delivery: DeliveryRuntime | None = None   # lazy (lanes)
        self._topics: list[str] = []
        self._batch_fn: Callable[[RDD, BatchInfo], Any] | None = None
        self._sinks: list[Callable[[BatchInfo], None]] = []
        # pull-model sources pumped before each micro-batch:
        # (source, topic, records per pump)
        self._sources: list[tuple[Any, str, int]] = []
        # per-topic produce round-robin cursor, kept across batches so short
        # polls do not restart at partition 0 every batch
        self._rr: dict[str, int] = {}
        # windowers whose state rides this context's commit protocol
        self._window_states: list[tuple[str, Any]] = []
        self._progress = (StreamProgress.load(checkpoint_path)
                          if checkpoint_path else StreamProgress())
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
        # windowed(...) tags its wrapper with the Windower it drives: attach
        # it so window state joins this context's commit protocol
        windower = getattr(fn, "windower", None)
        if windower is not None:
            self.attach_window_state(windower)

    def attach_window_state(self, windower: Any,
                            name: str | None = None) -> None:
        """Tie a :class:`~repro_torch.data.window.Windower` into the commit
        protocol. Attached windowers are rolled back to their last committed
        state when a batch fails (the replay must not find records already
        half-pushed), and — when the windower carries a
        :class:`~repro_torch.data.state.WindowStateStore` and this context
        has a ``checkpoint_path`` — their state is persisted each batch and
        published atomically with the consumed offsets, then restored here
        from the checkpoint's ref on a restart."""
        if any(w is windower for _, w in self._window_states):
            return                         # re-registered fn: already wired
        name = name or f"window-{len(self._window_states)}"
        if any(n == name for n, _ in self._window_states):
            raise ValueError(f"window state {name!r} already attached")
        self._window_states.append((name, windower))
        store = getattr(windower, "store", None)
        if store is None:
            return
        if not self.checkpoint_path:
            log.warning("window state store attached but the context has no "
                        "checkpoint_path: nothing to commit it against; the "
                        "store will not be written")
            return
        state = store.restore(self._progress.window_refs.get(name))
        if state is not None:
            windower.restore_state(state)
            if (state.t0 is not None and self._default_clock
                    and getattr(getattr(windower, "spec", None), "kind",
                                None) == "time"):
                log.warning(
                    "restored time-kind window state under the default "
                    "time.monotonic clock: its stream epoch (t0=%r) came "
                    "from the previous process and monotonic readings are "
                    "not comparable across restarts — window arithmetic "
                    "will be wrong. Inject a restart-comparable clock "
                    "(e.g. time.time) or use count windows.", state.t0)

    def add_sink(self, fn: Callable[[BatchInfo], None],
                 policy: Any = None, name: str | None = None) -> None:
        """Register a batch sink. Without a ``policy`` the sink runs serially
        in the batch thread, before the commit. With a
        :class:`~repro_torch.data.delivery.SinkPolicy`, the sink gets its own
        delivery lane — worker thread, bounded queue, failure isolation — on
        this context's :class:`~repro_torch.data.delivery.DeliveryRuntime`."""
        if policy is None:
            self._sinks.append(fn)
        else:
            self.delivery.add_batch_sink(fn, policy, name=name)

    @property
    def delivery(self) -> DeliveryRuntime:
        """The context's sink-delivery runtime (created on first use); its
        dead-letter topics live on this context's broker."""
        if self._delivery is None:
            self._delivery = DeliveryRuntime(broker=self.broker)
        return self._delivery

    # -- consumer-side accounting ------------------------------------------
    def _consumed(self, topic: str, parts: int) -> list[int]:
        """The consumed (checkpointed) start offsets, padded with zeros to
        the broker's current partition count."""
        starts = self._progress.offsets.setdefault(topic, [])
        starts.extend([0] * (parts - len(starts)))
        return starts

    def committed(self, topic: str) -> int:
        """Total records committed (processed) for a topic."""
        return sum(self._progress.offsets.get(topic, []))

    def lag(self, topic: str) -> int:
        """Produced-but-unprocessed records."""
        return sum(self.broker.end_offsets(topic)) - self.committed(topic)

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
                                    timestamp=self._clock())
                rr += 1
            self._rr[topic] = rr

    def run_one_batch(self) -> BatchInfo | None:
        """Paper Fig. 8 ``run_batch``: per-topic RDDs, union, process."""
        self._pump_sources()
        ranges = self._pending_ranges()
        if not ranges:
            return None
        info = BatchInfo(index=self._batch_index, ranges=ranges,
                         num_records=sum(r.count() for r in ranges),
                         scheduled_at=self._clock())
        per_topic: dict[str, list[OffsetRange]] = {}
        for r in ranges:
            per_topic.setdefault(r.topic, []).append(r)
        topic_rdds = [create_rdd(self.context, self.broker, rs)
                      for rs in per_topic.values()]
        union = topic_rdds[0].union(*topic_rdds[1:])
        # snapshot attached window state so a failed batch fn / serial sink
        # rolls back cleanly: the replay must not find records half-pushed
        rollback = [(w, w.state()) for _, w in self._window_states]
        t0 = time.perf_counter()
        try:
            if self._batch_fn is not None:
                info.result = self._batch_fn(union, info)
            info.processing_time = time.perf_counter() - t0
            # Serial sinks run BEFORE the commit: a raising sink aborts it
            # and the batch (windower pushes included, via the rollback
            # above) replays at the same offsets.
            for sink in self._sinks:
                sink(info)
        except BaseException:
            for w, st in rollback:
                w.restore_state(st)
            raise
        self._commit(ranges)
        self._batch_index += 1
        self._history.append(info)
        if self._delivery is not None:
            # parallel lanes: enqueue only; check() surfaces a fail_pipeline
            # lane's verdict (possibly from an earlier batch) and aborts here
            self._delivery.submit(info)
            self._delivery.check()
        return info

    def _commit(self, ranges: Sequence[OffsetRange]) -> None:
        """Advance consumed offsets + attached window state as one epoch.

        Window stores persist first (each returns the ref for this epoch);
        the checkpoint's single ``os.replace`` then publishes ``(offsets,
        epoch, refs)`` together. A crash between the two leaves the previous
        checkpoint pointing at the previous refs — the store's ``restore``
        truncates the unpublished tail, and the interrupted batch replays
        with its window pushes: offsets and window state move
        both-or-neither. Progress is also pushed broker-side."""
        epoch = self._progress.epoch + 1
        if self.checkpoint_path:
            for name, windower in self._window_states:
                store = getattr(windower, "store", None)
                if store is not None:
                    self._progress.window_refs[name] = \
                        store.commit(epoch, windower.state())
        for r in ranges:
            self._progress.offsets[r.topic][r.partition] = r.until
        self._progress.epoch = epoch
        if self.checkpoint_path:
            self._progress.save(self.checkpoint_path)
        for r in ranges:
            self.broker.commit(r.topic, r.partition, r.until)

    def checkpoint_now(self) -> None:
        """Checkpoint current progress + window state outside the batch loop
        — e.g. right after a terminal :meth:`Windower.flush`, so a restart
        does not re-fire the final partial window."""
        self._commit([])

    def close(self, drain: bool = True) -> None:
        """Shut down the delivery lanes. With ``drain=True`` (default) every
        queued batch is written before the lanes exit; ``drain=False``
        discards queued work. Raises a pending
        :class:`~repro_torch.data.delivery.DeliveryFailed`. Attached window
        state stores are closed (their last committed state stays on
        disk)."""
        try:
            if self._delivery is not None:
                self._delivery.close(drain=drain)
        finally:
            for _, windower in self._window_states:
                store = getattr(windower, "store", None)
                if store is not None:
                    store.close()

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
