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
progress lives in memory and broker-side.

The ``broker`` may equally be a :class:`~repro_torch.data.transport
.RemoteBroker`, which puts the consumer on the other side of a socket from
the detector (the paper's Fig. 7 split); after each committed batch the
context pushes its progress to the broker, so a *remote* producer's
backpressure measures lag against what was processed, not just appended.
Values read from a codec'd topic are decoded (:mod:`repro_torch.data.codec`)
before the subscriber's own ``value_decoder``.

Each committed batch leaves one trace span (:class:`~repro_torch.data
.metrics.BatchSpan`) in :attr:`StreamingContext.traces` — stages ``pump``,
``batch_fn``, ``sinks``, ``state_commit``, ``checkpoint``,
``broker_commit`` and ``delivery_submit``, tagged with the checkpoint epoch —
and moves the reference's ``stream_*`` instruments;
:meth:`StreamingContext.serve_observability` serves both over HTTP.

In consumer-group mode (:meth:`StreamingContext.join_group`) the context
consumes only the partitions the group's coordinator assigns it and commits
under ``(group, consumer, generation)``, so a stale owner is fenced. Over a
:class:`~repro_torch.data.replication.FailoverBroker` the context rebases
its cursor onto the promoted broker's log after each failover.
"""
from __future__ import annotations

import json
import os
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from repro_torch.core.broker import Broker, OffsetRange, create_rdd
from repro_torch.core.rdd import RDD, Context
from repro_torch.data.codec import compose_decoder
from repro_torch.data.delivery import DeliveryRuntime
from repro_torch.data.groups import GroupError, GroupMember
from repro_torch.data.metrics import TraceLog, get_registry
from repro_torch.data.obs_server import ObservabilityServer, lag_health
from repro_torch.utils import get_logger

log = get_logger(__name__)


def _stage(rec: Any, name: str):
    """A span-stage timer when a recorder is present, else a no-op — so
    ``_commit`` reads the same with and without tracing."""
    return rec.stage(name) if rec is not None else nullcontext()


def _keep_max(pending: dict[tuple[str, int], int],
              offsets: Sequence[tuple[str, int, int]]) -> None:
    """Record ``(topic, partition, offset)`` progress to commit again,
    keeping the furthest offset of each partition."""
    for topic, p, until in offsets:
        pending[(topic, p)] = max(until, pending.get((topic, p), 0))


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
        self._decoder: Callable[[Any], Any] | None = None
        self._batch_fn: Callable[[RDD, BatchInfo], Any] | None = None
        self._sinks: list[Callable[[BatchInfo], None]] = []
        # pull-model sources pumped before each micro-batch:
        # (source, topic, records per pump)
        self._sources: list[tuple[Any, str, int]] = []
        # per-topic produce round-robin cursor, kept across batches so short
        # polls do not restart at partition 0 every batch
        self._rr: dict[str, int] = {}
        # HA: a FailoverBroker bumps .failovers when it promotes a new
        # primary; the new primary's log may be shorter than our cursor
        # (asynchronous replication lost the tail), so the cursor is rebased
        self._last_failovers = getattr(broker, "failovers", 0)
        self.cursors_rewound = 0           # partition cursors the rebase moved
        # windowers whose state rides this context's commit protocol
        self._window_states: list[tuple[str, Any]] = []
        # consumer-group mode (join_group): when set, only assigned
        # partitions are consumed and broker commits carry (group, consumer,
        # generation) so the coordinator can fence stale owners
        self.group_member: GroupMember | None = None
        self._group_owned: dict[str, set[int]] = {}
        self._group_start_offset: Callable[[str, int], int | None] | None = \
            None
        self._group_on_rebalance: Callable[[dict, dict], None] | None = None
        # (topic, partition) -> offset processed here whose group commit was
        # fenced; committed again under the new generation while still owned
        self._group_unacked: dict[tuple[str, int], int] = {}
        # (topic, partition) -> offset processed here whose commit the broker
        # promoted mid-batch refused; committed again after the rebase
        self._failover_unacked: dict[tuple[str, int], int] = {}
        self._progress = (StreamProgress.load(checkpoint_path)
                          if checkpoint_path else StreamProgress())
        self._history: list[BatchInfo] = []
        self._batch_index = 0
        self.traces = TraceLog()
        self._obs_server: ObservabilityServer | None = None
        reg = self._registry = get_registry()
        self._m_batches = reg.counter(
            "stream_batches_total", help="micro-batches committed")
        self._m_records = reg.counter(
            "stream_records_total",
            help="records processed by committed batches")
        self._m_batch_s = reg.histogram(
            "stream_batch_seconds", help="end-to-end micro-batch duration")
        reg.gauge("stream_epoch",
                  help="checkpoint epoch of the last committed batch",
                  callback=lambda: self._progress.epoch)

    # -- wiring -------------------------------------------------------------
    def subscribe(self, topics: Sequence[str],
                  value_decoder: Callable[[Any], Any] | None = None) -> None:
        """Consume ``topics``; ``value_decoder`` runs on every value read,
        after the codec decode."""
        new = [t for t in topics if t not in self._topics]
        self._topics.extend(new)
        if value_decoder is not None:
            self._decoder = value_decoder
        for t in new:
            # evaluated per scrape, not per batch (a round trip on a remote
            # broker — priced where it is read, never on the hot path)
            self._registry.gauge(
                "stream_lag", help="produced-but-unprocessed records",
                labels={"topic": t}, callback=lambda t=t: self.lag(t))
        if new and self.group_member is not None:
            # subscription changed while in a group: re-join so the
            # coordinator assigns the new topics' partitions too
            self.group_member.topics = list(self._topics)
            self.group_member.join()

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

    # -- consumer-group mode ------------------------------------------------
    def join_group(self, group: str, consumer_id: str | None = None, *,
                   heartbeat_interval: float = 1.0,
                   session_timeout: float = 5.0,
                   start_offset: Callable[[str, int], int | None] | None = None,
                   on_rebalance: Callable[[dict, dict], None] | None = None,
                   clock: Callable[[], float] | None = None) -> GroupMember:
        """Enter consumer-group mode: this context consumes only the
        partitions the group coordinator assigns it, heartbeats at the top
        of every micro-batch, and commits offsets under ``(group, consumer,
        generation)`` so a stale owner is fenced instead of corrupting the
        group's progress.

        ``start_offset(topic, partition)`` resolves where a newly *gained*
        partition starts (from a handoff checkpoint, say — see
        :class:`~repro_torch.data.groups.GroupConsumer`); ``None`` falls back
        to the group's committed offset on the broker. ``on_rebalance
        (old_assignment, new_assignment)`` fires after the context applied
        an ownership change. Returns the :class:`~repro_torch.data.groups
        .GroupMember`, whose ``leave()`` runs in :meth:`close`."""
        if self.group_member is not None:
            raise ValueError("context already joined group "
                             f"{self.group_member.group!r}")
        self._group_start_offset = start_offset
        self._group_on_rebalance = on_rebalance
        self.group_member = GroupMember(
            self.broker, group, consumer_id, topics=list(self._topics),
            heartbeat_interval=heartbeat_interval,
            session_timeout=session_timeout, clock=clock,
            on_rebalance=self._apply_group_assignment)
        self._registry.gauge(
            "stream_group_partitions",
            help="partitions this consumer currently owns",
            labels={"group": group},
            callback=lambda: sum(len(p) for p in self._group_owned.values()))
        self.group_member.join()
        return self.group_member

    def _apply_group_assignment(self, old: dict, new: dict) -> None:
        """Adopt a new partition assignment: newly gained partitions get
        their start offset resolved (handoff checkpoint, else the group's
        broker-committed offset); lost partitions simply stop appearing in
        :meth:`_pending_ranges`. Fires the user ``on_rebalance`` last."""
        member = self.group_member
        for topic in self._topics:
            owned = set(new.get(topic, []))
            prev = self._group_owned.get(topic, set())
            starts = self._consumed(topic, self.broker.num_partitions(topic))
            for p in sorted(owned - prev):
                start = None
                if self._group_start_offset is not None:
                    start = self._group_start_offset(topic, p)
                if start is None:
                    done = self.broker.committed(topic, group=member.group)
                    start = done[p] if p < len(done) else 0
                if p >= len(starts):
                    starts.extend([0] * (p + 1 - len(starts)))
                starts[p] = int(start)
            self._group_owned[topic] = owned
        if self._group_on_rebalance is not None:
            self._group_on_rebalance(old, new)

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
        in_group = self.group_member is not None
        for topic in self._topics:
            ends = self.broker.end_offsets(topic)
            starts = self._consumed(topic, len(ends))
            owned = self._group_owned.get(topic, set()) if in_group else None
            for p, (start, end) in enumerate(zip(starts, ends)):
                if owned is not None and p not in owned:
                    continue           # another group member owns it
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

    def _rebase_after_failover(self) -> None:
        """Clamp start offsets to the new primary's log ends after a broker
        failover. Replication is asynchronous: the promoted follower may be
        missing a tail this consumer already read, and a start offset past
        the log end would silently skip every record the new primary appends
        below it. Clamping replays the gap instead — duplicates the
        idempotent-by-key sinks absorb."""
        for topic in self._topics:
            ends = self.broker.end_offsets(topic)
            starts = self._consumed(topic, len(ends))
            for p, end in enumerate(ends):
                if starts[p] > end:
                    log.warning(
                        "failover rebase: %s[%d] cursor %d is past the new "
                        "primary's end %d; rewinding (replayed records are "
                        "absorbed by idempotent sinks)",
                        topic, p, starts[p], end)
                    starts[p] = end
                    self.cursors_rewound += 1
        # progress that did not reach the promoted broker, refused inside
        # the last batch or fenced before the failover: commit it again,
        # each offset clamped to the new primary's end as the cursor was, or
        # the broker-side lag would stay above 0 for good
        pending, self._failover_unacked = self._failover_unacked, {}
        _keep_max(pending, [(t, p, u) for (t, p), u
                            in self._group_unacked.items()])
        self._group_unacked = {}
        ends = {t: self.broker.end_offsets(t) for t, _ in pending}
        self._broker_commit([(t, p, min(until, ends[t][p]))
                             for (t, p), until in sorted(pending.items())])

    def _recommit_fenced(self) -> None:
        """Commit, under the generation the member resynced at, the progress
        whose group commit was fenced, for the partitions it still owns.
        The local cursor is past those records, so no later batch would
        commit them: without this the group's lag would stay above zero
        for good when the fenced batch held a partition's last records.
        A partition that moved is the new owner's to commit; a commit
        fenced again is kept for the next try."""
        pending, self._group_unacked = self._group_unacked, {}
        self._broker_commit([(t, p, until)
                             for (t, p), until in sorted(pending.items())
                             if p in self._group_owned.get(t, ())])

    def run_one_batch(self) -> BatchInfo | None:
        """Paper Fig. 8 ``run_batch``: per-topic RDDs, union, process."""
        failovers = getattr(self.broker, "failovers", 0)
        if failovers != self._last_failovers:
            self._last_failovers = failovers
            self._rebase_after_failover()
        if self.group_member is not None:
            # heartbeat / rejoin as due; an ownership change lands through
            # _apply_group_assignment before ranges are computed
            self.group_member.maintain()
            if self._group_unacked:
                self._recommit_fenced()
        t_pump = time.perf_counter()
        self._pump_sources()
        ranges = self._pending_ranges()
        pump_s = time.perf_counter() - t_pump
        if not ranges:
            # no span for idle probes: the trace log holds batches, and an
            # idle poll loop would otherwise drown them
            return None
        info = BatchInfo(index=self._batch_index, ranges=ranges,
                         num_records=sum(r.count() for r in ranges),
                         scheduled_at=self._clock())
        rec = self.traces.begin(self._batch_index, info.num_records)
        rec.add("pump", pump_s)
        per_topic: dict[str, list[OffsetRange]] = {}
        for r in ranges:
            per_topic.setdefault(r.topic, []).append(r)
        # codec decode first (payload codecs are self-describing), then the
        # subscriber's own value_decoder
        decoder = compose_decoder(self._decoder)
        topic_rdds = [create_rdd(self.context, self.broker, rs, decoder)
                      for rs in per_topic.values()]
        union = topic_rdds[0].union(*topic_rdds[1:])
        # snapshot attached window state so a failed batch fn / serial sink
        # rolls back cleanly: the replay must not find records half-pushed
        rollback = [(w, w.state()) for _, w in self._window_states]
        t0 = time.perf_counter()
        try:
            with rec.stage("batch_fn"):
                if self._batch_fn is not None:
                    info.result = self._batch_fn(union, info)
            info.processing_time = time.perf_counter() - t0
            # Serial sinks run BEFORE the commit: a raising sink aborts it
            # and the batch (windower pushes included, via the rollback
            # above) replays at the same offsets.
            with rec.stage("sinks"):
                for sink in self._sinks:
                    sink(info)
        except BaseException:
            for w, st in rollback:
                w.restore_state(st)
            raise                      # failed batches never enter the trace
        self._commit(ranges, rec=rec)
        self._batch_index += 1
        self._history.append(info)
        if self._delivery is not None:
            # parallel lanes: enqueue only; check() surfaces a fail_pipeline
            # lane's verdict (possibly from an earlier batch) and aborts here
            with rec.stage("delivery_submit"):
                self._delivery.submit(info)
            self._delivery.check()
        span = rec.finish(self._progress.epoch)
        self._m_batches.inc()
        self._m_records.inc(info.num_records)
        self._m_batch_s.observe(span.total_s)
        return info

    def _commit(self, ranges: Sequence[OffsetRange],
                rec: Any = None) -> None:
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
            with _stage(rec, "state_commit"):
                for name, windower in self._window_states:
                    store = getattr(windower, "store", None)
                    if store is not None:
                        self._progress.window_refs[name] = \
                            store.commit(epoch, windower.state())
        for r in ranges:
            self._progress.offsets[r.topic][r.partition] = r.until
        self._progress.epoch = epoch
        if self.checkpoint_path:
            with _stage(rec, "checkpoint"):
                self._progress.save(self.checkpoint_path)
        with _stage(rec, "broker_commit"):
            self._broker_commit([(r.topic, r.partition, r.until)
                                 for r in ranges])

    def _broker_commit(self, offsets: Sequence[tuple[str, int, int]]) -> None:
        """Push ``(topic, partition, offset)`` progress broker-side.

        In group mode the commit carries (group, consumer, generation). A
        fenced commit means the group moved on mid-batch: local progress
        stands (a new owner replays from its own start offset; idempotent
        sinks absorb the overlap), the member resyncs at the top of the
        next batch and commits the fenced offsets again there for the
        partitions it kept. A broker that failed over inside this batch
        may refuse an offset past its log end (the promoted follower had
        not replicated all the batch read): local progress stands too, and
        every offset of the call is kept so that the next batch's rebase
        commits it again, clamped to the new primary's end."""
        member = self.group_member
        try:
            for topic, p, until in offsets:
                if member is None:
                    self.broker.commit(topic, p, until)
                else:
                    self.broker.commit(topic, p, until, group=member.group,
                                       consumer=member.consumer_id,
                                       generation=member.generation)
        except ValueError as e:        # GroupError is a ValueError
            failed_over = (getattr(self.broker, "failovers", 0)
                           != self._last_failovers)
            if isinstance(e, GroupError):
                log.warning("group commit fenced (%s); resyncing", e)
                member.request_resync()
            elif failed_over:
                log.warning("commit refused by the broker promoted during "
                            "the batch (%s); the next batch rebases", e)
            else:
                raise
            _keep_max(self._failover_unacked if failed_over
                      else self._group_unacked, offsets)

    def checkpoint_now(self) -> None:
        """Checkpoint current progress + window state outside the batch loop
        — e.g. right after a terminal :meth:`Windower.flush`, so a restart
        does not re-fire the final partial window."""
        self._commit([])

    def run_batches(self, max_batches: int) -> list[BatchInfo]:
        """Inline scheduler: up to ``max_batches`` micro-batches, stopping
        at the first poll with no data."""
        out = []
        while len(out) < max_batches:
            info = self.run_one_batch()
            if info is None:
                break
            out.append(info)
        return out

    def serve_observability(self, address: tuple[str, int] = ("127.0.0.1", 0),
                            lag_policy: Any = None) -> ObservabilityServer:
        """Start (or return) this context's HTTP observability endpoint:
        ``/metrics`` + ``/metrics.json`` over the registry the context's
        layers registered into, ``/traces`` over :attr:`traces`, and
        ``/health`` judging per-topic lag against ``lag_policy``'s
        ``scale_up_lag`` watermark (see ``repro_torch/data/obs_server.py``).
        Stopped by :meth:`close`; port 0 binds an ephemeral port — read the
        bound address from the returned server's ``.url``."""
        if self._obs_server is not None:
            return self._obs_server
        health = lag_health(
            lambda: {t: self.lag(t) for t in self._topics}, lag_policy)
        self._obs_server = ObservabilityServer(
            registry=self._registry, traces=self.traces,
            health_fn=health, address=address).start()
        return self._obs_server

    def close(self, drain: bool = True) -> None:
        """Shut down the delivery lanes. With ``drain=True`` (default) every
        queued batch is written before the lanes exit; ``drain=False``
        discards queued work. Raises a pending
        :class:`~repro_torch.data.delivery.DeliveryFailed`. Attached window
        state stores are closed (their last committed state stays on disk),
        the observability endpoint (if served) is stopped, and a group
        member leaves its group."""
        try:
            if self._delivery is not None:
                self._delivery.close(drain=drain)
        finally:
            for _, windower in self._window_states:
                store = getattr(windower, "store", None)
                if store is not None:
                    store.close()
            if self._obs_server is not None:
                self._obs_server.stop()
                self._obs_server = None
            if self.group_member is not None:
                self.group_member.leave()
                self.group_member = None

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
