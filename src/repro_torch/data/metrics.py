"""Process-wide metrics registry and batch-epoch trace spans, the
counterpart of ``repro/data/metrics.py``: one :class:`MetricsRegistry` every
layer of the port registers into, served over HTTP by
:mod:`repro_torch.data.obs_server`. Names, labels, help strings, kinds and
both renderings are the reference's, so one dashboard reads either package.

Three metric kinds, Prometheus-shaped:

- :class:`Counter` — monotonically increasing total (``inc``),
- :class:`Gauge`  — point-in-time value (``set``/``inc``/``dec``), or a
  *callback* gauge evaluated lazily at read time (per-topic log size, lane
  queue depth, consumer lag — reads that would cost something per event but
  are free to compute on scrape),
- :class:`Histogram` — observations bucketed into fixed latency buckets
  (``observe``), plus running sum/count.

Every metric keeps a bounded ring buffer of ``(t, value)`` samples —
:meth:`MetricsRegistry.sample` appends one point per metric, and the
observability endpoint calls it per scrape, so ``/metrics.json`` carries a
short time series without any per-event cost (Prometheus's pull model).

Metric identity is ``(name, labels)``; registering the same identity twice
returns the existing instrument, except that a callback gauge's callback is
*replaced* — latest wins — so a rebuilt component re-binds its live reads
instead of leaving the registry pointing at a dead object. The registry is
process-global: tests swap it with :func:`set_registry` / :func:`disabled`
so two components in one process do not share a gauge.

Hot-path cost: incrementing a counter is one lock and one add, and the
instrumented layers cache their instruments at construction (no registry
lookup per record). The off switch is :class:`NullRegistry` (every
operation a no-op). Locks come from :mod:`repro_torch.data.locktrace`.

**Batch-epoch trace spans** (:class:`TraceLog`, :class:`BatchSpan`): the
streaming context stamps one span per micro-batch — pump, batch fn, serial
sinks, state commit, checkpoint, broker commit, delivery enqueue, each
timed — tagged with the checkpoint epoch, into a bounded in-memory log. A
slow batch then decomposes into *which stage* took the time
(``GET /traces?last=N``).

**The span log** (:class:`Span`, :func:`span`, :func:`fine_span`,
:func:`cost_scope`): the port's one span API. The stages are spans of it,
and so is the work under them that the program marks (a task of the
scheduler, a sink write, the ART call, a train step, a decode step; and,
while a torch profiler records, each layer and its parts), each tagged
with its batch's index and placed on the profiler's timeline; the cost
scopes the dry-run's walker reads are spans of it too.
"""
from __future__ import annotations

import itertools
import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping

import torch

from repro_torch.data.locktrace import new_lock

# Fixed latency buckets (seconds): micro-batch and sink-write timings land
# between ~0.5 ms and ~10 s on the paper's workloads.
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# Power-of-two size buckets for batch/record-count histograms (flush sizes,
# produce batch sizes) — same exposition format, different axis.
COUNT_BUCKETS: tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096)

Labels = "Mapping[str, str] | None"


def _label_key(labels: Mapping[str, str] | None) -> tuple:
    return tuple(sorted((labels or {}).items()))


def _fmt_labels(items: tuple) -> str:
    if not items:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + inner + "}"


class _Metric:
    """Common base: identity, help text, and the sample ring buffer."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: tuple,
                 ring_size: int) -> None:
        self.name = name
        self.help = help
        self.labels = labels           # tuple of (key, value) pairs, sorted
        self.series: deque = deque(maxlen=ring_size)
        self._lock = new_lock("_Metric._lock")

    def value(self) -> float:          # pragma: no cover - overridden
        raise NotImplementedError

    def _record_sample(self, now: float) -> None:
        self.series.append((now, self.value()))

    def series_points(self) -> list[tuple[float, float]]:
        return list(self.series)


class Counter(_Metric):
    kind = "counter"

    def __init__(self, *args: Any, **kw: Any) -> None:
        super().__init__(*args, **kw)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n

    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, *args: Any,
                 callback: Callable[[], float] | None = None,
                 **kw: Any) -> None:
        super().__init__(*args, **kw)
        self._value = 0.0
        self.callback = callback

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    def value(self) -> float:
        if self.callback is not None:
            # a callback over a torn-down component (closed broker, joined
            # lane) must not poison the whole scrape
            try:
                return float(self.callback())
            except Exception:
                return math.nan
        with self._lock:
            return self._value


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, *args: Any,
                 buckets: Iterable[float] = DEFAULT_BUCKETS,
                 **kw: Any) -> None:
        super().__init__(*args, **kw)
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")
        self._counts = [0] * (len(self.buckets) + 1)   # +1 for +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        with self._lock:
            self._sum += v
            self._count += 1
            for i, bound in enumerate(self.buckets):
                if v <= bound:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def time(self) -> "_HistogramTimer":
        """``with hist.time(): ...`` observes the block's wall time."""
        return _HistogramTimer(self)

    def value(self) -> float:
        """Scalar view (for the ring buffer): total observations."""
        with self._lock:
            return float(self._count)

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            cum, counts = 0, []
            for c in self._counts:
                cum += c
                counts.append(cum)
            return {"buckets": list(self.buckets), "counts": counts,
                    "sum": self._sum, "count": self._count}


class _HistogramTimer:
    def __init__(self, hist: Histogram) -> None:
        self._hist = hist

    def __enter__(self) -> "_HistogramTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._hist.observe(time.perf_counter() - self._t0)


class MetricsRegistry:
    """Get-or-create instrument registry with per-metric sample rings.

    ``ring_size`` bounds each metric's time series; ``namespace`` prefixes
    every rendered metric name (default ``repro``).
    """

    def __init__(self, ring_size: int = 256, namespace: str = "repro",
                 clock: Callable[[], float] = time.time) -> None:
        self.ring_size = ring_size
        self.namespace = namespace
        self._clock = clock
        self._metrics: dict[tuple[str, tuple], _Metric] = {}
        self._lock = new_lock("MetricsRegistry._lock")

    # -- registration ------------------------------------------------------
    def _get_or_create(self, cls, name: str, help: str,
                       labels: Mapping[str, str] | None,
                       **kw: Any) -> _Metric:
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help, key[1], self.ring_size, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Mapping[str, str] | None = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Mapping[str, str] | None = None,
              callback: Callable[[], float] | None = None) -> Gauge:
        g = self._get_or_create(Gauge, name, help, labels)
        if callback is not None:
            g.callback = callback      # latest live object wins
        return g

    def histogram(self, name: str, help: str = "",
                  labels: Mapping[str, str] | None = None,
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    # -- reads -------------------------------------------------------------
    def metrics(self) -> "list[_Metric]":
        with self._lock:
            return list(self._metrics.values())

    def sample(self, now: float | None = None) -> None:
        """Append one ``(t, value)`` point to every metric's ring buffer.
        Called per scrape by the observability endpoint (and wherever else a
        series point is wanted) — sampling frequency is read frequency."""
        now = self._clock() if now is None else now
        for m in self.metrics():
            m._record_sample(now)

    def snapshot(self) -> dict[str, Any]:
        """The full registry as JSON-ready data: every metric's current
        value, kind, labels, histogram buckets, and ring-buffer series."""
        out: dict[str, Any] = {"sampled_at": self._clock(), "metrics": []}
        for m in self.metrics():
            entry: dict[str, Any] = {
                "name": m.name, "kind": m.kind, "help": m.help,
                "labels": dict(m.labels), "value": _json_num(m.value()),
                "series": [(t, _json_num(v)) for t, v in m.series_points()],
            }
            if isinstance(m, Histogram):
                entry["histogram"] = m.snapshot()
            out["metrics"].append(entry)
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (``GET /metrics``)."""
        by_name: dict[str, list[_Metric]] = {}
        for m in self.metrics():
            by_name.setdefault(m.name, []).append(m)
        lines: list[str] = []
        for name in sorted(by_name):
            group = by_name[name]
            full = f"{self.namespace}_{name}" if self.namespace else name
            head = group[0]
            if head.help:
                lines.append(f"# HELP {full} {head.help}")
            lines.append(f"# TYPE {full} {head.kind}")
            for m in group:
                lab = _fmt_labels(m.labels)
                if isinstance(m, Histogram):
                    snap = m.snapshot()
                    for bound, cum in zip(snap["buckets"], snap["counts"]):
                        ble = dict(m.labels)
                        ble["le"] = _fmt_float(bound)
                        lines.append(f"{full}_bucket"
                                     f"{_fmt_labels(tuple(sorted(ble.items())))}"
                                     f" {cum}")
                    inf = dict(m.labels)
                    inf["le"] = "+Inf"
                    lines.append(f"{full}_bucket"
                                 f"{_fmt_labels(tuple(sorted(inf.items())))}"
                                 f" {snap['count']}")
                    lines.append(f"{full}_sum{lab} {_fmt_float(snap['sum'])}")
                    lines.append(f"{full}_count{lab} {snap['count']}")
                else:
                    lines.append(f"{full}{lab} {_fmt_float(m.value())}")
        return "\n".join(lines) + "\n"


def _fmt_float(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _json_num(v: float):
    """JSON has no NaN: a dead callback gauge serializes as null."""
    return None if isinstance(v, float) and math.isnan(v) else v


class _NullInstrument:
    """Absorbs every instrument call; shared singleton."""

    def inc(self, n: float = 1.0) -> None: ...
    def dec(self, n: float = 1.0) -> None: ...
    def set(self, v: float) -> None: ...
    def observe(self, v: float) -> None: ...

    def time(self) -> "_NullTimer":
        return _NULL_TIMER

    def value(self) -> float:
        return 0.0


class _NullTimer:
    def __enter__(self) -> "_NullTimer":
        return self

    def __exit__(self, *exc: Any) -> None: ...


_NULL_INSTRUMENT = _NullInstrument()
_NULL_TIMER = _NullTimer()


class NullRegistry:
    """Registry-off: every instrument is a shared no-op. This is the "bare"
    leg of the ``--check`` overhead guard, and the escape hatch for a
    pipeline that wants zero telemetry tax."""

    def counter(self, *a: Any, **kw: Any) -> Any:
        return _NULL_INSTRUMENT

    def gauge(self, *a: Any, **kw: Any) -> Any:
        return _NULL_INSTRUMENT

    def histogram(self, *a: Any, **kw: Any) -> Any:
        return _NULL_INSTRUMENT

    def metrics(self) -> list:
        return []

    def sample(self, now: float | None = None) -> None: ...

    def snapshot(self) -> dict[str, Any]:
        return {"sampled_at": time.time(), "metrics": []}

    def prometheus_text(self) -> str:
        return "\n"


# -- process-wide default ----------------------------------------------------

_default_registry: Any = MetricsRegistry()
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every layer registers into by default."""
    return _default_registry


def set_registry(registry: Any) -> Any:
    """Swap the process-wide registry (returns the previous one). Pass a
    fresh :class:`MetricsRegistry` for test isolation, or a
    :class:`NullRegistry` to turn instrumentation off for components
    constructed afterwards (instruments are cached at construction)."""
    global _default_registry
    with _default_lock:
        prev = _default_registry
        _default_registry = registry
        return prev


class disabled:
    """``with metrics.disabled(): ...`` — components constructed inside see
    a :class:`NullRegistry` (the bench harness's bare leg)."""

    def __enter__(self) -> NullRegistry:
        self._prev = set_registry(NullRegistry())
        return _default_registry

    def __exit__(self, *exc: Any) -> None:
        set_registry(self._prev)


# -- the span log -------------------------------------------------------------
#
# A span is one piece of work: its name, its parent span, the index of the
# micro-batch it belongs to (every span of a batch carries it, on whichever
# thread it ran), its thread, its start and end on ``time.perf_counter``,
# and for a device span the device time between a pair of CUDA events
# recorded on the current stream, resolved when it is read. Spans nest per
# thread; a span on another thread names its parent explicitly (the
# ``TaskScheduler`` hands each task the span that submitted it).
#
# Batch-level spans (``span``) are recorded whenever they run inside a
# micro-batch. Fine spans (``fine_span``, ``cost_scope``) are recorded only
# while a torch profiler records; otherwise they cost one test of a bool.
# While the profiler records, every span is also a host-side profiler range
# named ``SPAN_PREFIX + name``, and the first span on the main thread emits
# an anchor range whose time on the span clock is kept, so that a span on a
# thread the profiler does not record can be placed on the trace's clock
# (``anchor_offset_us``). A committed batch's spans stay readable after its
# ``StreamingContext`` is gone (``recent_batches``).

SPAN_PREFIX = "repro_torch/"
ANCHOR = SPAN_PREFIX + "anchor."
RECENT_BATCHES = 512

_profiler = torch.autograd.profiler
_RecordFunctionFast = getattr(torch._C._profiler, "_RecordFunctionFast",
                              None)
_clock = time.perf_counter
_tls = threading.local()
_span_ids = itertools.count(1)
_anchor_ids = itertools.count(1)
_listeners: list = []                  # cost walkers (launch/opcost.py)
_recent: deque = deque(maxlen=RECENT_BATCHES)
_anchors: deque = deque(maxlen=64)     # (anchor number, its span-clock time)


class _AnchorState:
    anchored = False                   # this profiler session has its anchor


def tracing() -> bool:
    """Whether a torch profiler records now: fine spans are on."""
    return bool(_profiler._is_profiler_enabled)


def _stack() -> list:
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        return _tls.stack


def current_span() -> "Span | None":
    """The innermost open span on this thread."""
    stack = _stack()
    return stack[-1] if stack else None


def _anchor() -> None:
    """Emit the profiler session's anchor range from the main thread (the
    one that starts the profiler) and keep its time on the span clock."""
    if (_RecordFunctionFast is None
            or threading.current_thread() is not threading.main_thread()):
        return
    seq = next(_anchor_ids)
    rf = _RecordFunctionFast(f"{ANCHOR}{seq}")
    t0 = _clock()
    rf.__enter__()
    t1 = _clock()
    rf.__exit__(None, None, None)
    _anchors.append((seq, (t0 + t1) / 2))
    _AnchorState.anchored = True


def anchor_offset_us(events: Iterable[Any]) -> float | None:
    """The offset that puts the span clock on a profiled window's clock:
    a span time ``t`` (seconds) lies at ``t * 1e6 + offset`` among the
    window's events' ``time_range`` (µs). None when the events hold no
    anchor this process emitted."""
    times = dict(_anchors)
    offset = None
    for ev in events:
        if ev.name.startswith(ANCHOR):
            t = times.get(int(ev.name[len(ANCHOR):]))
            if t is not None:
                offset = ev.time_range.start - t * 1e6
    return offset


class Span:
    """One span (see the section's comment). ``with`` opens and closes it;
    ``device_s`` reads its device time, or None for a host span, a span
    still open, or one run before CUDA was initialised."""

    __slots__ = ("id", "name", "parent", "batch", "thread", "start", "end",
                 "attrs", "_into", "_keep", "_device", "_events",
                 "_device_s", "_range", "_walkers")

    def __init__(self, name: str, parent: "Span | None" = None, *,
                 keep: bool = True, device: bool = False,
                 attrs: dict | None = None,
                 walkers: list | None = None) -> None:
        self.id = next(_span_ids)
        self.name = name
        self.parent = parent
        self.batch = None if parent is None else parent.batch
        self.thread = threading.get_native_id()
        self.start: float | None = None
        self.end: float | None = None
        self.attrs = attrs
        self._into = None if parent is None else parent._into
        self._keep = keep
        self._device = device
        self._events = None
        self._device_s = None
        self._range = None
        self._walkers = walkers

    def __enter__(self) -> "Span":
        if _profiler._is_profiler_enabled:
            if not _AnchorState.anchored:
                _anchor()
            if _RecordFunctionFast is not None:
                self._range = _RecordFunctionFast(SPAN_PREFIX + self.name)
                self._range.__enter__()
        elif _AnchorState.anchored:
            _AnchorState.anchored = False
        if self._walkers:
            for w in self._walkers:
                w.enter_scope(self.name)
        _stack().append(self)
        if self._device and torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self.start = _clock()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.end = _clock()
        if self._events is not None:
            self._events[1].record()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if self._walkers:
            for w in reversed(self._walkers):
                w.exit_scope(self.name)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._keep and self._into is not None:
            self._into.append(self)

    @property
    def device_s(self) -> float | None:
        events = self._events
        if events is not None and self.end is not None:
            events[1].synchronize()
            self._device_s = events[0].elapsed_time(events[1]) / 1e3
            self._events = None
        return self._device_s

    def as_dict(self) -> dict[str, Any]:
        return {"id": self.id, "name": self.name,
                "parent": None if self.parent is None else self.parent.id,
                "batch": self.batch, "thread": self.thread,
                "start": self.start, "end": self.end,
                "device_s": self.device_s, "attrs": dict(self.attrs or {})}


class _NullSpan:
    """What a span that records nothing returns: enters and exits, no
    allocation."""

    __slots__ = ()
    device_s = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


def span(name: str, *, device: bool = False, scope: bool = False,
         parent: Span | None = None, attrs: dict | None = None) -> Any:
    """A batch-level span: recorded whenever it runs inside a micro-batch
    (its parent, by default this thread's innermost span, belongs to one),
    a profiler range while the profiler records. ``device`` adds the CUDA
    event pair; ``scope`` makes it a cost scope the walkers see; ``parent``
    joins a span of another thread."""
    if parent is None:
        parent = current_span()
    walkers = list(_listeners) if scope and _listeners else None
    if (parent is None and walkers is None
            and not _profiler._is_profiler_enabled):
        return _NULL_SPAN
    return Span(name, parent, device=device, attrs=attrs, walkers=walkers)


def fine_span(name: str, *, device: bool = False,
              attrs: dict | None = None) -> Any:
    """A fine span: recorded only while a profiler records; otherwise one
    test of a bool, no allocation."""
    if not _profiler._is_profiler_enabled:
        return _NULL_SPAN
    return Span(name, current_span(), device=device, attrs=attrs)


def cost_scope(name: str, index: int | None = None, *,
               device: bool = False, attrs: dict | None = None) -> Any:
    """A fine span that is also a cost scope: the dry-run's walker
    (``launch/opcost.py``) files the operations run inside under its name
    (``f"{name}{index}"`` with an index). With no profiler recording and
    no walker listening, one test of a bool. ``device`` adds the event
    pair while a profiler records."""
    if not (_profiler._is_profiler_enabled or _listeners):
        return _NULL_SPAN
    profiling = bool(_profiler._is_profiler_enabled)
    return Span(name if index is None else f"{name}{index}", current_span(),
                keep=profiling, device=device and profiling, attrs=attrs,
                walkers=list(_listeners) or None)


def add_listener(walker: Any) -> None:
    """``walker.enter_scope(name)`` and ``exit_scope(name)`` on every cost
    scope from now on, on every thread, innermost last in, first out."""
    _listeners.append(walker)


def remove_listener(walker: Any) -> None:
    _listeners.remove(walker)


# -- batch-epoch trace spans -------------------------------------------------

@dataclass
class BatchSpan:
    """One micro-batch decomposed into stages. ``stages`` maps stage name ->
    seconds; ``epoch`` is the checkpoint epoch the batch committed as (the
    atomic (offsets, window state) publication), so a span joins exactly
    one durable point in the stream. ``spans`` holds the batch's spans,
    the batch's own first, then each as it ended; ``traced`` whether a
    profiler recorded when the batch began."""
    batch_index: int
    epoch: int
    num_records: int
    started_at: float                # wall clock (time.time)
    total_s: float = 0.0
    stages: dict[str, float] = field(default_factory=dict)
    traced: bool = False
    spans: list = field(default_factory=list, repr=False)

    def as_dict(self) -> dict[str, Any]:
        return {"batch_index": self.batch_index, "epoch": self.epoch,
                "num_records": self.num_records,
                "started_at": self.started_at,
                "total_s": self.total_s,
                "stages": dict(self.stages),
                "traced": self.traced,
                "spans": [s.as_dict() for s in list(self.spans)]}


# Stage names in pipeline order (docs/observability.md documents each):
SPAN_STAGES = ("pump", "batch_fn", "sinks", "state_commit", "checkpoint",
               "broker_commit", "delivery_submit")


class _Stage(Span):
    """A stage of a batch: a span that adds its seconds to the batch's
    ``stages`` (re-entering a stage adds to it)."""

    __slots__ = ("_stages",)

    def __init__(self, name: str, parent: Span, stages: dict) -> None:
        super().__init__(name, parent)
        self._stages = stages

    def __exit__(self, *exc: Any) -> None:
        super().__exit__(*exc)
        self._stages[self.name] = (self._stages.get(self.name, 0.0)
                                   + self.end - self.start)


class SpanRecorder:
    """Builds one :class:`BatchSpan` stage by stage.

    The batch's own span (``batch``) opens here, on this thread, so that
    every span run in the batch joins it. ``pump``, a :class:`Span` that
    ran before the batch was known (the source pump that discovers whether
    there is a batch at all), becomes its first stage. ``with
    rec.stage("batch_fn"): ...`` times a stage; ``finish(epoch)`` stamps
    the epoch + total and hands the span to the trace log and to
    ``recent_batches``; ``abandon()`` closes a batch that failed, which
    neither sees. Cost per batch: a few spans and one deque append —
    priced by the same ``--check`` overhead guard as the registry.
    """

    def __init__(self, log: "TraceLog", batch_index: int,
                 num_records: int, pump: Span | None = None) -> None:
        self._log = log
        self.span = BatchSpan(batch_index=batch_index, epoch=-1,
                              num_records=num_records,
                              started_at=time.time(), traced=tracing())
        stack = _stack()
        for i, s in enumerate(stack):       # a batch left open by a failure
            if s.parent is None and s._into is not None:
                del stack[i:]
                break
        root = Span("batch", keep=False)
        root.batch = batch_index
        root._into = self.span.spans
        self.span.spans.append(root)
        root.__enter__()
        if pump is not None:            # before the batch's own span, so
            pump.batch = batch_index        # beside it, as on the timeline
            self.span.spans.append(pump)
            self.span.stages["pump"] = pump.end - pump.start
        self._root = root
        self._t0 = _clock()

    def stage(self, name: str) -> _Stage:
        return _Stage(name, self._root, self.span.stages)

    def finish(self, epoch: int) -> BatchSpan:
        self.span.epoch = epoch
        self.span.total_s = _clock() - self._t0
        self._root.__exit__(None, None, None)
        self._log.record(self.span)
        _recent.append(self.span)
        return self.span

    def abandon(self) -> None:
        self._root.__exit__(None, None, None)


class TraceLog:
    """Bounded in-memory log of recent :class:`BatchSpan` s."""

    def __init__(self, capacity: int = 512) -> None:
        self._spans: deque = deque(maxlen=capacity)
        self._lock = new_lock("TraceLog._lock")
        self.recorded = 0

    def begin(self, batch_index: int, num_records: int,
              pump: Span | None = None) -> SpanRecorder:
        return SpanRecorder(self, batch_index, num_records, pump)

    def record(self, span: BatchSpan) -> None:
        with self._lock:
            self._spans.append(span)
            self.recorded += 1

    def last(self, n: int | None = None) -> list[BatchSpan]:
        with self._lock:
            spans = list(self._spans)
        if n is None:
            return spans
        return spans[-n:] if n > 0 else []     # spans[-0:] would be all

    def stage_totals(self) -> dict[str, float]:
        """Cumulative seconds per stage across retained spans — the
        "which stage ate the time" rollup the ptycho example prints."""
        totals: dict[str, float] = {}
        for span in self.last():
            for name, dt in span.stages.items():
                totals[name] = totals.get(name, 0.0) + dt
        return totals


def recent_batches(n: int | None = None) -> list[dict[str, Any]]:
    """The last ``n`` micro-batches (all kept, at most ``RECENT_BATCHES``)
    that any ``StreamingContext`` of this process committed, oldest first,
    each as ``BatchSpan.as_dict()`` with its spans' device times resolved:
    the spans outlive the context that recorded them."""
    batches = list(_recent)
    if n is not None:
        batches = batches[-n:] if n > 0 else []
    return [b.as_dict() for b in batches]
