"""Ingest runtime, the counterpart of ``repro/data/ingest.py``: pump
sources into broker topics with bounded-queue backpressure (DELTA's
generator process, minus MPI).

The paper's near-real-time criterion — per-batch processing time must stay
under the batch interval — is only meaningful if overload is *observable*.
An unbounded broker log hides it: producers never block, consumers just
fall further behind. :class:`IngestRunner` bounds the produced-but-
unconsumed lag per topic and applies a policy when the bound is hit:

- ``block``  — the source waits (lossless; the instrument must buffer),
- ``drop``   — newest records are discarded (lossy, bounded lag),
- ``sample`` — keep every k-th record (the stream thins instead of
  stalling).

Lag is measured against the consumer's committed offsets (a
:class:`~repro_torch.core.dstream.StreamingContext`, or a consumer group's
broker-side offsets), so backpressure reflects what the pipeline has
processed, not just what it has been handed.

The runner is transport-agnostic: ``broker`` may be the in-process
:class:`~repro_torch.core.broker.Broker` or a
:class:`~repro_torch.data.transport.RemoteBroker` speaking to a
consumer-side :class:`~repro_torch.data.transport.BrokerServer`. In the
remote topology pass the same client as ``consumer=`` (its ``lag()`` is
computed from the offsets the consumer committed broker-side), and producer
backpressure keeps working across the process/host boundary.

Produce is *batched*: polled records buffer per source and flush through
``broker.produce_many`` (one call per partition) when ``flush_records`` /
``flush_bytes`` worth have accumulated or the oldest buffered record ages
past ``flush_interval`` — over the socket transport one frame per batch
instead of one round trip per record. Buffered records count against
``max_pending``, so the backpressure bounds are unchanged. A payload codec
(:mod:`repro_torch.data.codec`) encodes values at the flush.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from repro_torch.core.broker import Broker
from repro_torch.data.codec import get_codec
from repro_torch.data.metrics import COUNT_BUCKETS, get_registry
from repro_torch.data.sources import Source
from repro_torch.utils import get_logger

log = get_logger(__name__)

POLICIES = ("block", "drop", "sample")


@dataclass(frozen=True)
class IngestConfig:
    """Per-source ingest knobs."""
    topic: str
    partitions: int = 1            # topic created with this many if missing
    poll_batch: int = 64           # max records per source poll
    policy: str = "block"          # block | drop | sample when over max_pending
    # Bound on produced-but-unconsumed records. "block" never exceeds it;
    # "drop"/"sample" check at poll granularity, so the observed lag is
    # bounded by max_pending + poll_batch. Records buffered for a batched
    # produce count against the bound (the runner subtracts them from room).
    max_pending: int = 1024
    sample_stride: int = 4         # "sample": keep 1 of every stride records
    rate_limit: float | None = None  # producer-side cap, records/s
    # Batched produce: polled records buffer until one of these trips, then
    # flush as one produce_many per partition (one transport frame instead of
    # one per record — the fast path bench_ingest prices). flush_records=1
    # restores PR 2's per-record produce.
    flush_records: int = 64        # flush when this many records buffered
    flush_bytes: int = 1 << 20     # ... or the buffered payload estimate hits
    flush_interval: float = 0.02   # ... or the oldest buffered record ages out
    # When the topic is consumed by a consumer group,
    # name it here: backpressure then measures lag against the *group's*
    # broker-committed offsets (group members never advance the default
    # group's offsets, so the runner's usual lag signal would read the
    # whole log as unconsumed and block forever).
    consumer_group: str = ""
    # Payload codec (repro_torch.data.codec) applied to every value at the flush
    # boundary — the DELTA-style "reduce at the source" hook. None inherits
    # the topic's own codec (create_topic(codec=...)); topics this runner
    # creates are created *with* this codec so late-joining producers
    # inherit it too. Values are self-describing, so consumers decode with
    # no configuration (StreamingContext/TopicSource already do).
    codec: str | None = None

    def __post_init__(self) -> None:
        if self.policy not in POLICIES:
            raise ValueError(f"policy {self.policy!r} not in {POLICIES}")
        if self.flush_records < 1:
            raise ValueError("flush_records must be >= 1")


@dataclass
class SourceMetrics:
    """Per-source throughput/lag accounting."""
    topic: str = ""
    produced: int = 0
    dropped: int = 0
    sampled_out: int = 0
    polls: int = 0
    produce_calls: int = 0         # broker produce/produce_many round trips
    blocked_s: float = 0.0
    started_at: float = 0.0
    last_produce_at: float = 0.0
    max_observed_lag: int = 0

    @property
    def throughput(self) -> float:
        """Records/s over the active window (0 before any produce)."""
        dt = self.last_produce_at - self.started_at
        return self.produced / dt if dt > 0 else 0.0

    def as_dict(self) -> dict:
        return {"topic": self.topic, "produced": self.produced,
                "dropped": self.dropped, "sampled_out": self.sampled_out,
                "polls": self.polls, "produce_calls": self.produce_calls,
                "blocked_s": round(self.blocked_s, 4),
                "throughput_rec_per_s": round(self.throughput, 1),
                "max_observed_lag": self.max_observed_lag}


def _estimate_bytes(value) -> int:
    """Cheap payload-size estimate for the flush_bytes threshold."""
    nbytes = getattr(value, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    if isinstance(value, (bytes, bytearray, memoryview, str)):
        return len(value)
    return 64


def _deep_bytes(value) -> int:
    """Container-walking size estimate for the codec byte counters (codec'd
    values are dicts wrapping arrays/blobs, which _estimate_bytes treats as
    opaque 64-byte objects)."""
    nbytes = getattr(value, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    if isinstance(value, (bytes, bytearray, memoryview, str)):
        return len(value)
    if isinstance(value, dict):
        return sum(_deep_bytes(v) for v in value.values()) + 16 * len(value)
    if isinstance(value, (list, tuple)):
        return sum(_deep_bytes(v) for v in value) + 8 * len(value)
    return 8


@dataclass
class _Entry:
    source: Source
    config: IngestConfig
    metrics: SourceMetrics
    rr: int = 0                    # round-robin partition cursor
    partitions: int = 1            # cached topic partition count (see add())
    buf: list = field(default_factory=list)   # (key, value, partition)
    buf_bytes: int = 0
    buf_oldest: float = 0.0        # monotonic time of oldest buffered record
    # effective payload codec, resolved once in add() (config override, else
    # the topic's create_topic codec); None = raw, nothing touches the value
    codec: Any = None
    # registry instruments, resolved once in add() so the pump loop pays a
    # plain attribute read per event, never a registry lookup
    m_polls: Any = None
    m_produced: Any = None
    m_dropped: Any = None
    m_sampled: Any = None
    m_blocked: Any = None
    m_flush: Any = None
    m_codec_in: Any = None
    m_codec_out: Any = None


class IngestRunner:
    """Pumps N sources into broker topics, on a thread or inline.

    ``lag_of(topic)`` reports produced-but-unconsumed records; pass
    ``consumer=StreamingContext`` to derive it from committed offsets, or a
    custom callable. With neither, lag is always 0 and backpressure is off.
    """

    def __init__(self, broker: Broker, consumer=None,
                 lag_of: Callable[[str], int] | None = None,
                 idle_sleep: float = 0.002) -> None:
        self.broker = broker
        if lag_of is not None:
            self._lag_of = lag_of
        elif consumer is not None:
            self._lag_of = consumer.lag
        else:
            self._lag_of = lambda topic: 0
        self._entries: list[_Entry] = []
        self._idle_sleep = idle_sleep
        self._pumping = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def add(self, source: Source, config: IngestConfig) -> SourceMetrics:
        if config.topic not in self.broker.topics():
            try:
                if config.codec is not None:
                    self.broker.create_topic(config.topic, config.partitions,
                                             codec=config.codec)
                else:
                    self.broker.create_topic(config.topic, config.partitions)
            except ValueError:
                # another producer won the check-then-create race, or a
                # retried remote create whose first ack was lost — either
                # way the topic exists now, which is all add() needs
                pass
        m = SourceMetrics(topic=config.topic)
        # partition count is immutable per topic: query once, not per poll
        # (over RemoteBroker that query is a full round trip)
        n = self.broker.num_partitions(config.topic)
        e = _Entry(source, config, m, partitions=n)
        # effective codec, resolved once: the config's override, else the
        # topic's own (pre-existing topics keep their create_topic codec).
        # "raw"/None both mean "leave the value alone" — skip the encode
        # call entirely on that hot path.
        name = config.codec
        if name is None:
            topic_codec = getattr(self.broker, "topic_codec", None)
            if topic_codec is not None:
                name = topic_codec(config.topic)
        if name is not None:
            codec = get_codec(name)
            e.codec = None if codec.name == "raw" else codec
        self._register_metrics(e)
        self._entries.append(e)
        return m

    def _register_metrics(self, e: _Entry) -> None:
        reg = get_registry()
        topic = e.config.topic
        labels = {"topic": topic}
        e.m_polls = reg.counter(
            "ingest_polls_total", help="source poll() calls", labels=labels)
        e.m_produced = reg.counter(
            "ingest_produced_records_total",
            help="records handed to the broker", labels=labels)
        e.m_dropped = reg.counter(
            "ingest_dropped_records_total",
            help="records shed by the drop policy", labels=labels)
        e.m_sampled = reg.counter(
            "ingest_sampled_out_records_total",
            help="records thinned away by the sample policy", labels=labels)
        e.m_blocked = reg.counter(
            "ingest_blocked_seconds_total",
            help="time the block policy held the source", labels=labels)
        e.m_flush = reg.histogram(
            "ingest_flush_records", help="records per batched flush",
            labels=labels, buckets=COUNT_BUCKETS)
        if e.codec is not None:
            codec_labels = {"topic": topic, "codec": e.codec.name}
            e.m_codec_in = reg.counter(
                "ingest_codec_bytes_in",
                help="estimated value bytes entering the codec at flush",
                labels=codec_labels)
            e.m_codec_out = reg.counter(
                "ingest_codec_bytes_out",
                help="estimated value bytes after codec encode",
                labels=codec_labels)
        reg.gauge("ingest_lag", help="produced-but-unconsumed records",
                  labels=labels,
                  callback=lambda e=e: self._lag(e))

    @property
    def metrics(self) -> list[SourceMetrics]:
        return [e.metrics for e in self._entries]

    def _lag(self, e: _Entry) -> int:
        """The entry's backpressure signal: the consumer group's broker-side
        committed offsets when ``config.consumer_group`` names one, else the
        runner-level ``lag_of``/consumer."""
        if e.config.consumer_group:
            return self.broker.lag(e.config.topic,
                                   group=e.config.consumer_group)
        return self._lag_of(e.config.topic)

    def lag_snapshot(self) -> dict[str, int]:
        """Current produced-but-unconsumed lag per topic — the live signal
        (``max_observed_lag`` is a high-water mark and never drains) that
        the reference's ``LagPolicy`` scales the worker set on."""
        return {e.config.topic: self._lag(e) for e in self._entries}

    @property
    def done(self) -> bool:
        """Every source exhausted AND its records handed to the broker.

        A source reports ``exhausted`` the moment its last ``poll`` returns,
        which is *before* those records reach the broker — a visible window
        when produce crosses a socket (RemoteBroker), and wider still with
        batched produce (records sit in the flush buffer). Reading
        ``exhausted`` first, then the buffers, then the pump-in-progress flag
        closes it: if the flag is clear and the buffers are empty after
        exhaustion was observed, the pump that drained the source has fully
        produced.
        """
        exhausted = all(e.source.exhausted for e in self._entries)
        flushed = all(not e.buf for e in self._entries)
        return exhausted and flushed and not self._pumping

    # -- one pump step -----------------------------------------------------
    def _produce(self, e: _Entry, records) -> None:
        """Buffer polled records for a batched flush; flush immediately when
        a size threshold trips (the deadline is pump()'s job)."""
        if not records:
            return
        cfg = e.config
        now = time.monotonic()
        for key, value in records:
            if not e.buf:
                e.buf_oldest = now
            e.buf.append((key, value, e.rr % e.partitions))
            e.buf_bytes += _estimate_bytes(value)
            e.rr += 1
            if (len(e.buf) >= cfg.flush_records
                    or e.buf_bytes >= cfg.flush_bytes):
                self._flush(e, now)

    def _flush(self, e: _Entry, now: float | None = None) -> int:
        """Hand the buffered records to the broker: one ``produce_many`` per
        partition (one transport frame each), preserving per-partition order.
        Returns the number of records flushed."""
        if not e.buf:
            return 0
        buf, e.buf, e.buf_bytes = e.buf, [], 0
        now = time.monotonic() if now is None else now
        by_partition: dict[int, list] = {}
        if e.codec is not None:
            # the source→broker encode boundary: values are codec'd here and
            # travel encoded through the broker, the durable log, and the
            # replication path; consumers decode at subscribe
            encode = e.codec.encode
            bytes_in = bytes_out = 0
            for i, (key, value, partition) in enumerate(buf):
                bytes_in += _deep_bytes(value)
                value = encode(value)
                bytes_out += _deep_bytes(value)
                buf[i] = (key, value, partition)
            e.m_codec_in.inc(bytes_in)
            e.m_codec_out.inc(bytes_out)
        for key, value, partition in buf:
            by_partition.setdefault(partition, []).append((key, value))
        produce_many = getattr(self.broker, "produce_many", None)
        for partition, pairs in by_partition.items():
            if produce_many is not None and len(pairs) > 1:
                produce_many(e.config.topic, pairs, partition=partition,
                             timestamp=now)
            else:
                for key, value in pairs:
                    self.broker.produce(e.config.topic, value, key=key,
                                        partition=partition, timestamp=now)
            e.metrics.produce_calls += (1 if produce_many is not None
                                        and len(pairs) > 1 else len(pairs))
        e.metrics.produced += len(buf)
        e.metrics.last_produce_at = now
        e.m_produced.inc(len(buf))
        e.m_flush.observe(len(buf))
        return len(buf)

    def _pump_one(self, e: _Entry) -> int:
        """Poll one source once, apply rate limit + backpressure policy.
        Returns records polled into the pipeline (for idle detection)."""
        src, cfg, m = e.source, e.config, e.metrics
        if src.exhausted:
            return 0
        if m.started_at == 0.0:
            m.started_at = time.monotonic()
        want = cfg.poll_batch
        if cfg.rate_limit is not None:
            elapsed = time.monotonic() - m.started_at
            due = int(cfg.rate_limit * elapsed) + 1
            want = min(want, max(0, due - m.produced - len(e.buf)))
            if want == 0:
                return 0
        lag = self._lag(e)
        m.max_observed_lag = max(m.max_observed_lag, lag)
        # records buffered for the next flush are already claimed pipeline
        # room: count them, or batching would overshoot max_pending
        room = cfg.max_pending - lag - len(e.buf)
        if room <= 0:
            if cfg.policy == "block":
                # the broker may still have space the buffer is holding;
                # push the buffer through so the consumer sees it, then wait
                self._flush(e)
                m.blocked_s += self._idle_sleep
                e.m_blocked.inc(self._idle_sleep)
                return 0                  # do not poll; source waits
            records = src.poll(want)
            m.polls += 1
            e.m_polls.inc()
            if cfg.policy == "drop":
                m.dropped += len(records)
                e.m_dropped.inc(len(records))
                return 0
            # sample: thin to 1/stride, hard-capped so lag never exceeds
            # max_pending + poll_batch even when the consumer is stalled
            kept = records[::cfg.sample_stride]
            hard_room = cfg.max_pending + cfg.poll_batch - lag - len(e.buf)
            kept = kept[:max(0, hard_room)]
            m.sampled_out += len(records) - len(kept)
            e.m_sampled.inc(len(records) - len(kept))
            self._produce(e, kept)
            return len(kept)
        if cfg.policy == "block":
            want = min(want, room)
        records = src.poll(want)
        m.polls += 1
        e.m_polls.inc()
        self._produce(e, records)
        return len(records)

    def pump(self) -> int:
        """One round over all sources; returns total records moved (polled
        into the pipeline or flushed to the broker)."""
        self._pumping = True
        try:
            moved = sum(self._pump_one(e) for e in self._entries)
            now = time.monotonic()
            for e in self._entries:
                # deadline flush: no record waits in the buffer past
                # flush_interval, and an exhausted source drains immediately
                if e.buf and (e.source.exhausted
                              or now - e.buf_oldest >= e.config.flush_interval):
                    moved += self._flush(e, now)
            return moved
        finally:
            self._pumping = False

    # -- drive -------------------------------------------------------------
    def run_inline(self, timeout: float | None = None) -> None:
        """Pump until every source is exhausted (tests/benchmarks)."""
        # `is not None`, not truthiness: timeout=0 must mean "one pass, then
        # give up immediately", never the accidental "wait forever"
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        while not self.done:
            if self.pump() == 0:
                if deadline is not None and time.monotonic() > deadline:
                    log.warning("ingest run_inline timed out; %d sources "
                                "unfinished",
                                sum(not e.source.exhausted
                                    for e in self._entries))
                    return
                time.sleep(self._idle_sleep)

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ingest-runner")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            if self.pump() == 0:
                if self.done:
                    return
                self._stop.wait(self._idle_sleep)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def join(self, timeout: float | None = None) -> bool:
        """Wait for the background pump to finish all sources."""
        if self._thread is None:
            return self.done
        self._thread.join(timeout)
        return self.done


def ingest_all(broker: Broker, pairs: Sequence[tuple[Source, IngestConfig]],
               consumer=None) -> list[SourceMetrics]:
    """Convenience: pump every (source, config) pair to completion inline."""
    runner = IngestRunner(broker, consumer=consumer)
    out = [runner.add(s, c) for s, c in pairs]
    runner.run_inline()
    return out
