"""Parallel sink delivery, the counterpart of ``repro/data/delivery.py``:
one worker lane per sink, with failure policies.

A serial sink is written in the batch thread, so the slowest sink sets the
latency of the whole output stage, and one raising sink aborts delivery for
all of them. Here each sink gets its own worker thread and bounded queue (a
delivery *lane*): the batch thread only pays an enqueue, and failure stays
in the lane it happened in.

Per-lane behaviour is a :class:`SinkPolicy`:

=================  ==========================================================
policy             on terminal write failure (after ``retries`` attempts)
=================  ==========================================================
``skip_batch``     drop this batch for this sink, keep the lane running
``dead_letter``    produce the batch's items to a dead-letter topic on the
                   broker (key preserved; value wraps sink/batch/error)
``fail_pipeline``  flag the runtime; the next ``submit``/``check``/``close``
                   raises :class:`DeliveryFailed` in the batch thread
=================  ==========================================================

Orthogonal knobs: ``retries`` (with ``retry_backoff`` between), ``timeout``
(a per-batch write deadline, enforced by running the sink on a lane-private
thread — a hung sink wedges only its own lane), and queue-full behaviour
(``on_full="block"`` applies backpressure to the batch thread; ``"drop"``
refuses the new batch and counts it).

Delivery is asynchronous: a submitted batch is only guaranteed written after
``drain()`` or ``close(drain=True)``. The streaming layer commits offsets
when the batch *processes*, before lanes write, so a process that dies
without ``close`` loses up to ``queue_depth`` queued batches per lane; a
write abandoned at its deadline may still land, and its retry then
duplicates it — the idempotent-by-key sinks absorb both.

Wiring: :meth:`repro_torch.core.dstream.StreamingContext.add_sink` and
:meth:`repro_torch.core.pipeline.NearRealTimePipeline.add_sink` take an
optional ``policy=``; with one, the sink moves onto a lane of the context's
:class:`DeliveryRuntime`. Per-lane counters are in
:meth:`DeliveryRuntime.report`, and each lane registers the reference's
nine ``delivery_*`` instruments, labelled with its name, in the metrics
registry (:mod:`repro_torch.data.metrics`).
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from repro_torch.data.locktrace import new_lock
from repro_torch.data.metrics import get_registry
from repro_torch.data.sinks import describe_result_items
from repro_torch.utils import get_logger

log = get_logger(__name__)

FAILURE_ACTIONS = ("skip_batch", "dead_letter", "fail_pipeline")
QUEUE_FULL = ("block", "drop")

_CLOSE = object()                     # lane shutdown sentinel


class DeliveryFailed(RuntimeError):
    """A lane with ``on_failure="fail_pipeline"`` exhausted its retries."""

    def __init__(self, lane: str, error: BaseException) -> None:
        super().__init__(f"sink lane {lane!r} failed pipeline: {error!r}")
        self.lane = lane
        self.error = error


class SinkTimeoutError(RuntimeError):
    """A sink write exceeded its policy timeout (or the sink is still stuck
    in a previous timed-out write — a *wedged* lane)."""


@dataclass(frozen=True)
class SinkPolicy:
    """Per-sink delivery policy. Build via the named constructors
    (:meth:`retry`, :meth:`skip_batch`, :meth:`dead_letter`,
    :meth:`fail_pipeline`) or directly."""

    retries: int = 0               # re-attempts before the failure action
    on_failure: str = "skip_batch"
    dead_letter_topic: str | None = None
    timeout: float | None = None   # per-batch write deadline, seconds
    queue_depth: int = 64          # bounded lane queue (batches)
    on_full: str = "block"         # block | drop when the queue is full
    retry_backoff: float = 0.0     # sleep between retry attempts

    def __post_init__(self) -> None:
        if self.on_failure not in FAILURE_ACTIONS:
            raise ValueError(
                f"on_failure {self.on_failure!r} not in {FAILURE_ACTIONS}")
        if self.on_failure == "dead_letter" and not self.dead_letter_topic:
            raise ValueError("dead_letter policy needs dead_letter_topic")
        if self.on_full not in QUEUE_FULL:
            raise ValueError(f"on_full {self.on_full!r} not in {QUEUE_FULL}")
        if self.retries < 0:
            raise ValueError("retries must be >= 0")
        if self.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")

    # -- named constructors (the policy names the docs/tests use) ----------
    @classmethod
    def retry(cls, n: int, then: str = "skip_batch", **kw: Any) -> "SinkPolicy":
        """Retry ``n`` times, then apply ``then`` (default: skip the batch)."""
        return cls(retries=n, on_failure=then, **kw)

    @classmethod
    def skip_batch(cls, **kw: Any) -> "SinkPolicy":
        return cls(on_failure="skip_batch", **kw)

    @classmethod
    def dead_letter(cls, topic: str, **kw: Any) -> "SinkPolicy":
        return cls(on_failure="dead_letter", dead_letter_topic=topic, **kw)

    @classmethod
    def fail_pipeline(cls, **kw: Any) -> "SinkPolicy":
        return cls(on_failure="fail_pipeline", **kw)


@dataclass
class LaneMetrics:
    """Per-lane counters surfaced by :meth:`DeliveryRuntime.report`."""
    name: str = ""
    enqueued: int = 0
    delivered: int = 0             # batches written successfully
    failed: int = 0                # batches that exhausted retries
    retries: int = 0               # individual re-attempts
    dropped_full: int = 0          # batches refused by on_full="drop"
    dead_lettered: int = 0         # batches routed to the dead-letter topic
    discarded: int = 0             # batches thrown away by close(drain=False)
    max_depth: int = 0             # high-water queue depth
    leaked_thread: bool = False    # a wedged sink outlived close()
    last_error: str | None = None
    latencies: list[float] = field(default_factory=list)   # submit -> done
    write_s: list[float] = field(default_factory=list)     # write call alone

    def as_dict(self) -> dict[str, Any]:
        out = {"name": self.name, "enqueued": self.enqueued,
               "delivered": self.delivered, "failed": self.failed,
               "retries": self.retries, "dropped_full": self.dropped_full,
               "dead_lettered": self.dead_lettered,
               "discarded": self.discarded, "max_depth": self.max_depth,
               "last_error": self.last_error}
        if self.latencies:
            out["mean_latency_s"] = sum(self.latencies) / len(self.latencies)
            out["max_latency_s"] = max(self.latencies)
        if self.write_s:
            out["mean_write_s"] = sum(self.write_s) / len(self.write_s)
        if self.leaked_thread:
            out["leaked_thread"] = True
        return out


class _TimedExecutor:
    """Lane-private thread that runs sink writes under a deadline.

    The lane worker hands each call over and waits ``timeout`` for its done
    event. A call that blows the deadline is abandoned (its event belongs to
    that call alone, so a late completion cannot be mistaken for a newer
    call's); while the sink is still stuck, subsequent calls fail fast as
    *wedged*. The thread is daemonic — a sink that never returns cannot keep
    the process alive, only its own lane broken.
    """

    def __init__(self, write: Callable[[Any], None], name: str) -> None:
        self._write = write
        self._calls: queue.Queue = queue.Queue()
        self._last: dict | None = None
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name=f"{name}-exec")
        self.thread.start()

    def _loop(self) -> None:
        while True:
            item = self._calls.get()
            if item is _CLOSE:
                return
            call, payload = item
            try:
                self._write(payload)
            except BaseException as e:   # noqa: BLE001 - handed to the lane
                call["error"] = e
            call["done"].set()

    def submit(self, payload: Any, timeout: float) -> None:
        if self._last is not None and not self._last["done"].wait(timeout):
            raise SinkTimeoutError(
                "sink still executing a previous timed-out batch (wedged)")
        call = {"done": threading.Event(), "error": None}
        self._last = call
        self._calls.put((call, payload))
        if not call["done"].wait(timeout):
            raise SinkTimeoutError(f"sink write exceeded {timeout}s")
        if call["error"] is not None:
            raise call["error"]

    def close(self) -> bool:
        """Returns True if the executor thread exited (False = wedged)."""
        self._calls.put(_CLOSE)
        self.thread.join(timeout=0.5)
        return not self.thread.is_alive()


class SinkLane:
    """One sink's worker thread + bounded queue.

    ``write(payload)`` performs the sink write; ``items_of(payload)`` maps a
    payload back to keyed items for dead-lettering (may return ``[]``).
    """

    def __init__(self, name: str, write: Callable[[Any], None],
                 policy: SinkPolicy, runtime: "DeliveryRuntime",
                 items_of: Callable[[Any], list] | None = None,
                 index_of: Callable[[Any], int] | None = None,
                 sink_close: Callable[[], None] | None = None) -> None:
        self.name = name
        self.policy = policy
        self.metrics = LaneMetrics(name=name)
        self._write = write
        self._items_of = items_of or (lambda payload: [])
        self._index_of = index_of or (lambda payload: -1)
        self._sink_close = sink_close
        self._runtime = runtime
        self._queue: queue.Queue = queue.Queue(maxsize=policy.queue_depth)
        self._discard = False
        # lane names label the instruments, so every lane shows up in
        # /metrics
        reg = get_registry()
        labels = {"lane": name}
        self._m_enqueued = reg.counter(
            "delivery_enqueued_total", help="batches accepted by the lane",
            labels=labels)
        self._m_delivered = reg.counter(
            "delivery_delivered_total", help="batches written successfully",
            labels=labels)
        self._m_failed = reg.counter(
            "delivery_failed_total", help="batches that exhausted retries",
            labels=labels)
        self._m_retries = reg.counter(
            "delivery_retries_total", help="individual write re-attempts",
            labels=labels)
        self._m_dropped = reg.counter(
            "delivery_dropped_full_total",
            help='batches refused by on_full="drop"', labels=labels)
        self._m_dead = reg.counter(
            "delivery_dead_lettered_total",
            help="batches routed to the dead-letter topic", labels=labels)
        self._m_write = reg.histogram(
            "delivery_write_seconds", help="sink write call duration",
            labels=labels)
        self._m_latency = reg.histogram(
            "delivery_latency_seconds", help="submit-to-written latency",
            labels=labels)
        reg.gauge("delivery_queue_depth", help="batches queued on the lane",
                  labels=labels, callback=self._queue.qsize)
        self._executor = (_TimedExecutor(write, name)
                          if policy.timeout is not None else None)
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"sink-lane-{name}")
        self.thread.start()

    @property
    def depth(self) -> int:
        return self._queue.qsize()

    # -- producer side (batch thread) --------------------------------------
    def submit(self, payload: Any) -> bool:
        """Enqueue one batch; returns False if dropped (on_full="drop")."""
        item = (time.perf_counter(), payload)
        if self.policy.on_full == "drop":
            try:
                self._queue.put_nowait(item)
            except queue.Full:
                self.metrics.dropped_full += 1
                self._m_dropped.inc()
                return False
        else:
            # block in short slices, re-checking for a fail_pipeline verdict
            # from ANOTHER lane: a blocked enqueue must not outlive an
            # aborted pipeline
            while True:
                try:
                    self._queue.put(item, timeout=0.05)
                    break
                except queue.Full:
                    self._runtime.check()
        self.metrics.enqueued += 1
        self._m_enqueued.inc()
        self.metrics.max_depth = max(self.metrics.max_depth, self.depth)
        return True

    # -- worker side --------------------------------------------------------
    def _run(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is _CLOSE:
                    return
                if self._discard:
                    self.metrics.discarded += 1
                    continue
                self._deliver(*item)
            finally:
                self._queue.task_done()

    def _write_once(self, payload: Any) -> None:
        t0 = time.perf_counter()
        try:
            if self._executor is not None:
                self._executor.submit(payload, self.policy.timeout)
            else:
                self._write(payload)
        finally:
            dt = time.perf_counter() - t0
            self.metrics.write_s.append(dt)
            self._m_write.observe(dt)

    def _deliver(self, enqueued_at: float, payload: Any) -> None:
        error: BaseException | None = None
        for attempt in range(self.policy.retries + 1):
            if attempt:
                self.metrics.retries += 1
                self._m_retries.inc()
                if self.policy.retry_backoff:
                    time.sleep(self.policy.retry_backoff)
            try:
                self._write_once(payload)
                self.metrics.delivered += 1
                self._m_delivered.inc()
                lat = time.perf_counter() - enqueued_at
                self.metrics.latencies.append(lat)
                self._m_latency.observe(lat)
                return
            except BaseException as e:   # noqa: BLE001 - policy decides
                error = e
        self.metrics.failed += 1
        self._m_failed.inc()
        self.metrics.last_error = repr(error)
        log.warning("sink lane %s: batch failed after %d attempt(s): %r",
                    self.name, self.policy.retries + 1, error)
        if self.policy.on_failure == "dead_letter":
            try:
                self._runtime._dead_letter(
                    self.name, self.policy.dead_letter_topic,
                    self._index_of(payload), self._items_of(payload), error)
                self.metrics.dead_lettered += 1
                self._m_dead.inc()
            except Exception as e:       # broker gone: isolate, don't crash
                log.error("sink lane %s: dead-letter write failed: %r",
                          self.name, e)
        elif self.policy.on_failure == "fail_pipeline":
            self._runtime._flag_failure(self.name, error)

    # -- shutdown -----------------------------------------------------------
    def close(self, drain: bool = True, timeout: float | None = None) -> None:
        if not self.thread.is_alive():
            return
        if not drain:
            self._discard = True
        # bounded enqueue of the sentinel: a wedged sink may never free
        # queue space, and close() must honor its timeout even then
        deadline = (time.monotonic() + timeout) if timeout is not None else None
        while True:
            try:
                self._queue.put_nowait(_CLOSE)
                break
            except queue.Full:
                # `is not None`: close(timeout=0) means "try once, abandon
                # immediately" — a falsy deadline must not disable the bound
                if deadline is not None and time.monotonic() > deadline:
                    self.metrics.leaked_thread = True
                    log.warning("sink lane %s: queue still full after %ss; "
                                "abandoning worker", self.name, timeout)
                    return
                time.sleep(0.002)
        self.thread.join(timeout=(max(0.0, deadline - time.monotonic())
                                  if deadline is not None else None))
        if self.thread.is_alive():
            self.metrics.leaked_thread = True
            log.warning("sink lane %s: worker did not exit in %ss",
                        self.name, timeout)
        if self._executor is not None and not self._executor.close():
            self.metrics.leaked_thread = True
        if self._sink_close is not None:
            try:
                self._sink_close()
            except Exception as e:
                log.warning("sink lane %s: close() raised %r", self.name, e)


class DeliveryRuntime:
    """Fans each batch out to per-sink lanes; owns failure isolation.

    ``submit(info)`` enqueues the batch on every lane and returns
    immediately (modulo ``on_full="block"`` backpressure). Keyed lanes
    receive the batch result normalized to ``(key, value)`` items (computed
    once per batch); batch lanes receive the :class:`BatchInfo` itself.
    """

    def __init__(self, broker: Any = None) -> None:
        self.broker = broker
        self._lanes: list[tuple[str, SinkLane]] = []   # (kind, lane)
        self._failure: DeliveryFailed | None = None
        self._failure_lock = new_lock("DeliveryRuntime._failure_lock")
        self._dl_lock = new_lock("DeliveryRuntime._dl_lock")

    @property
    def lanes(self) -> list[SinkLane]:
        return [lane for _, lane in self._lanes]

    def _require_broker(self, policy: SinkPolicy) -> None:
        if policy.on_failure == "dead_letter" and self.broker is None:
            raise ValueError(
                "dead_letter policy needs a broker on the DeliveryRuntime")

    def _lane_name(self, obj: Any, name: str | None) -> str:
        base = name or type(obj).__name__
        taken = {lane.name for _, lane in self._lanes}
        if base not in taken:
            return base
        i = 2
        while f"{base}-{i}" in taken:
            i += 1
        return f"{base}-{i}"

    def add_sink(self, sink: Any, policy: SinkPolicy,
                 name: str | None = None) -> SinkLane:
        """Keyed sink (``write_batch``): lane payload is ``(index, items)``."""
        self._require_broker(policy)
        lane = SinkLane(
            self._lane_name(sink, name),
            write=lambda payload: sink.write_batch(payload[1]),
            policy=policy, runtime=self,
            items_of=lambda payload: payload[1],
            index_of=lambda payload: payload[0],
            sink_close=getattr(sink, "close", None))
        self._lanes.append(("keyed", lane))
        return lane

    def add_batch_sink(self, fn: Callable[[Any], None], policy: SinkPolicy,
                       name: str | None = None,
                       sink_close: Callable[[], None] | None = None
                       ) -> SinkLane:
        """Batch-level sink (``fn(BatchInfo)``): lane payload is the info."""
        self._require_broker(policy)
        lane = SinkLane(
            self._lane_name(fn, name), write=fn, policy=policy, runtime=self,
            index_of=lambda info: getattr(info, "index", -1),
            sink_close=sink_close)
        self._lanes.append(("batch", lane))
        return lane

    # -- per-batch ----------------------------------------------------------
    def submit(self, info: Any, items: Sequence | None = None) -> None:
        """Fan one batch out to every lane. Raises :class:`DeliveryFailed`
        first if a fail_pipeline lane already gave up (so a blocked enqueue
        can never outlive an aborted pipeline)."""
        self.check()
        keyed = None
        for kind, lane in self._lanes:
            if kind == "keyed":
                if keyed is None:
                    if items is not None:
                        keyed = list(items)
                    else:
                        keyed = describe_result_items(
                            getattr(info, "result", info),
                            getattr(info, "index", 0))
                lane.submit((getattr(info, "index", 0), keyed))
            else:
                lane.submit(info)

    def check(self) -> None:
        """Raise if a fail_pipeline lane has failed."""
        if self._failure is not None:
            raise self._failure

    def _flag_failure(self, lane: str, error: BaseException) -> None:
        with self._failure_lock:
            if self._failure is None:
                self._failure = DeliveryFailed(lane, error)

    def _dead_letter(self, lane: str, topic: str, index: int,
                     items: Sequence, error: BaseException | None) -> None:
        """Route a failed batch to the dead-letter topic: one record per
        item, key preserved, value wrapping enough to replay or debug."""
        with self._dl_lock:
            if topic not in self.broker.topics():
                try:
                    self.broker.create_topic(topic, 1)
                except ValueError:
                    pass               # another lane won the create race
        records = list(items) or [(f"{lane}-batch-{index:06d}", None)]
        for key, value in records:
            self.broker.produce(
                topic,
                {"sink": lane, "batch": index, "error": repr(error),
                 "value": value},
                key=key.encode() if isinstance(key, str) else key)

    # -- lifecycle ----------------------------------------------------------
    def drain(self, timeout: float | None = None) -> bool:
        """Block until every lane's queue is empty and its last write
        returned. Returns False on timeout."""
        deadline = (time.monotonic() + timeout) if timeout is not None else None
        for _, lane in self._lanes:
            while lane.depth > 0 or lane._queue.unfinished_tasks:
                if deadline is not None and time.monotonic() > deadline:
                    return False
                time.sleep(0.001)
        return True

    def close(self, drain: bool = True, timeout: float | None = 30.0) -> None:
        """Stop every lane (draining queued batches unless ``drain=False``),
        close the underlying sinks, and surface a pending fail_pipeline
        failure. Idempotent."""
        for _, lane in self._lanes:
            lane.close(drain=drain, timeout=timeout)
        self.check()

    def report(self) -> dict[str, dict[str, Any]]:
        """Per-lane depth/latency/failure counters, keyed by lane name —
        the sink-side siblings of ``MetricsSink.report()``."""
        out = {}
        for _, lane in self._lanes:
            d = lane.metrics.as_dict()
            d["depth"] = lane.depth
            out[lane.name] = d
        return out
