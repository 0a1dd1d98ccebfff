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
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping

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


# -- batch-epoch trace spans -------------------------------------------------

@dataclass
class BatchSpan:
    """One micro-batch decomposed into stages. ``stages`` maps stage name ->
    seconds; ``epoch`` is the checkpoint epoch the batch committed as (the
    atomic (offsets, window state) publication), so a span joins exactly
    one durable point in the stream."""
    batch_index: int
    epoch: int
    num_records: int
    started_at: float                # wall clock (time.time)
    total_s: float = 0.0
    stages: dict[str, float] = field(default_factory=dict)

    def as_dict(self) -> dict[str, Any]:
        return {"batch_index": self.batch_index, "epoch": self.epoch,
                "num_records": self.num_records,
                "started_at": self.started_at,
                "total_s": self.total_s,
                "stages": dict(self.stages)}


# Stage names in pipeline order (docs/observability.md documents each):
SPAN_STAGES = ("pump", "batch_fn", "sinks", "state_commit", "checkpoint",
               "broker_commit", "delivery_submit")


class SpanRecorder:
    """Builds one :class:`BatchSpan` stage by stage.

    ``with rec.stage("pump"): ...`` accumulates (re-entering a stage adds to
    it); ``finish(epoch)`` stamps the epoch + total and hands the span to
    the trace log. Cost per batch: a few ``perf_counter`` calls and one
    deque append — priced by the same ``--check`` overhead guard as the
    registry.
    """

    def __init__(self, log: "TraceLog", batch_index: int,
                 num_records: int) -> None:
        self._log = log
        self.span = BatchSpan(batch_index=batch_index, epoch=-1,
                              num_records=num_records,
                              started_at=time.time())
        self._t0 = time.perf_counter()

    def stage(self, name: str) -> "_StageTimer":
        return _StageTimer(self.span.stages, name)

    def add(self, name: str, seconds: float) -> None:
        """Fold an externally-measured duration into a stage (accumulating)
        — for work timed before the recorder could exist (e.g. the source
        pump that discovers whether there is a batch at all)."""
        self.span.stages[name] = self.span.stages.get(name, 0.0) + seconds

    def finish(self, epoch: int) -> BatchSpan:
        self.span.epoch = epoch
        self.span.total_s = time.perf_counter() - self._t0
        self._log.record(self.span)
        return self.span


class _StageTimer:
    def __init__(self, stages: dict[str, float], name: str) -> None:
        self._stages = stages
        self._name = name

    def __enter__(self) -> "_StageTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        dt = time.perf_counter() - self._t0
        self._stages[self._name] = self._stages.get(self._name, 0.0) + dt


class TraceLog:
    """Bounded in-memory log of recent :class:`BatchSpan` s."""

    def __init__(self, capacity: int = 512) -> None:
        self._spans: deque = deque(maxlen=capacity)
        self._lock = new_lock("TraceLog._lock")
        self.recorded = 0

    def begin(self, batch_index: int, num_records: int) -> SpanRecorder:
        return SpanRecorder(self, batch_index, num_records)

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
