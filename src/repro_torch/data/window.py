"""Windowing over micro-batches, the counterpart of ``repro/data/window.py``:
tumbling and sliding count/time windows.

Spark's DStream API exposes ``window(windowLength, slideInterval)`` over
micro-batches; this module reproduces that composition for
:class:`~repro_torch.core.dstream.StreamingContext`. A window function
wraps a user batch function: records accumulate across micro-batches and
the user function fires once per *complete* window — the paper's §III
"reconstruct over the last K frames" without app-side buffering.

Count windows index records; time windows bucket by the arrival
micro-batch's schedule time (all records in a batch share its timestamp,
Spark's discretization).

The open window is consumer *state*. Hand the windower a
:class:`~repro_torch.data.state.WindowStateStore` (``Windower(spec, fn,
store=...)`` / ``windowed(spec, fn, store=...)``) and the streaming context
commits it atomically with the consumed offsets each batch, restoring both
together on restart (see ``repro_torch/data/state.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.core.dstream import BatchInfo
from repro_torch.core.rdd import RDD
from repro_torch.data.state import WindowState, WindowStateStore


@dataclass(frozen=True)
class WindowSpec:
    """``size``/``slide`` in records (``kind="count"``) or seconds
    (``kind="time"``). ``slide`` defaults to ``size`` (tumbling); a smaller
    slide overlaps windows (sliding)."""
    size: float
    slide: float | None = None
    kind: str = "count"

    def __post_init__(self) -> None:
        if self.kind not in ("count", "time"):
            raise ValueError(f"kind {self.kind!r} not in ('count', 'time')")
        if self.size <= 0:
            raise ValueError("window size must be > 0")
        if self.slide is not None and self.slide <= 0:
            raise ValueError("window slide must be > 0")

    @property
    def stride(self) -> float:
        return self.slide if self.slide is not None else self.size


@dataclass
class WindowInfo:
    """Metadata handed to the window function alongside the records."""
    index: int                       # 0-based window sequence number
    start: float                     # first record index / window start time
    end: float                       # one-past-last index / window end time
    num_records: int = 0
    batches: list[int] = field(default_factory=list)   # contributing batches
    partial: bool = False            # True only for an end-of-stream flush


@dataclass
class _Pending:
    value: Any
    ts: float          # arrival time relative to stream epoch
    batch: int


class Windower:
    """Accumulates records across micro-batches and fires complete windows.

    Use via :func:`windowed`, or drive ``push``/``flush`` directly. The
    window function receives ``(records, WindowInfo)`` and its return values
    are collected as the wrapped batch function's result.
    """

    def __init__(self, spec: WindowSpec,
                 fn: Callable[[list[Any], WindowInfo], Any],
                 store: WindowStateStore | None = None) -> None:
        self.spec = spec
        self.fn = fn
        self.store = store               # committed by the StreamingContext
        self._buf: list[_Pending] = []
        self._evicted = 0                # records dropped off the front
        self._t0: float | None = None    # stream epoch (time kind)
        self._windows_fired = 0

    # -- restartable state --------------------------------------------------
    def state(self) -> WindowState:
        """Snapshot the restartable state (shallow: record values shared)."""
        return WindowState(buf=[(p.value, p.ts, p.batch) for p in self._buf],
                           evicted=self._evicted, t0=self._t0,
                           windows_fired=self._windows_fired)

    def restore_state(self, state: WindowState) -> None:
        """Adopt a previously committed state — the restart path, and the
        rollback path when a batch fails after pushing (the replay must not
        find its records already half-pushed)."""
        self._buf = [_Pending(v, ts, b) for v, ts, b in state.buf]
        self._evicted = state.evicted
        self._t0 = state.t0
        self._windows_fired = state.windows_fired

    # -- record intake ------------------------------------------------------
    def push(self, records: list[Any], info: BatchInfo) -> list[Any]:
        """Add one micro-batch worth of records; fire any complete windows.
        Returns the list of window-function results fired by this push."""
        t = info.scheduled_at
        if self._t0 is None:
            self._t0 = t
        rel = t - self._t0
        self._buf.extend(_Pending(v, rel, info.index) for v in records)
        if self.spec.kind == "count":
            return self._fire_count()
        return self._fire_time(now=rel)

    def flush(self) -> list[Any]:
        """End-of-stream: fire one final partial window if records remain.

        The partial ``WindowInfo`` keeps the complete-window contract that
        ``end`` is an *exclusive bound* on the contents: one past the last
        record index (count kind), or the open window's scheduled end
        ``start + size`` (time kind — every buffered ``ts`` is below it,
        exactly the bounds the window would have reported had it closed).
        """
        if not self._buf:
            return []
        if self.spec.kind == "count":
            start = float(self._evicted)
            end = start + len(self._buf)
        else:
            start = self._windows_fired * self.spec.stride
            end = start + self.spec.size
        result = self._fire(self._buf, start, end, partial=True)
        self._buf = []
        return [result]

    # -- firing -------------------------------------------------------------
    def _fire(self, pend: list[_Pending], start: float, end: float,
              partial: bool = False) -> Any:
        info = WindowInfo(index=self._windows_fired, start=start, end=end,
                          num_records=len(pend),
                          batches=sorted({p.batch for p in pend}),
                          partial=partial)
        self._windows_fired += 1
        return self.fn([p.value for p in pend], info)

    def _fire_count(self) -> list[Any]:
        size, stride = int(self.spec.size), int(self.spec.stride)
        out = []
        while len(self._buf) >= size:
            start = float(self._evicted)
            out.append(self._fire(self._buf[:size], start, start + size))
            self._buf = self._buf[stride:]
            self._evicted += stride
        return out

    def _fire_time(self, now: float) -> list[Any]:
        size, stride = self.spec.size, self.spec.stride
        out = []
        while True:
            w_start = self._windows_fired * stride
            w_end = w_start + size
            if now < w_end:       # window still open
                break
            in_window = [p for p in self._buf if w_start <= p.ts < w_end]
            out.append(self._fire(in_window, w_start, w_end))
            next_start = self._windows_fired * stride
            keep = [p for p in self._buf if p.ts >= next_start]
            self._evicted += len(self._buf) - len(keep)
            self._buf = keep
        return out


def windowed(spec: WindowSpec,
             fn: Callable[[list[Any], WindowInfo], Any],
             windower_out: list | None = None,
             store: WindowStateStore | None = None
             ) -> Callable[[RDD, BatchInfo], Any]:
    """Wrap a window function as a ``foreach_batch`` function.

    ``sc.foreach_batch(windowed(WindowSpec(size=64), fn))`` collects each
    micro-batch RDD, accumulates, and calls ``fn(records, window_info)``
    whenever a window completes; the batch result is the (possibly empty)
    list of window results. Pass ``windower_out=[]`` to receive the
    :class:`Windower` (index 0) for end-of-stream ``flush()``.

    The returned function carries its :class:`Windower` as a ``windower``
    attribute; ``StreamingContext.foreach_batch`` auto-attaches it to the
    context's commit protocol (rollback on a failed batch and — with a
    ``store`` and a ``checkpoint_path`` — restart-safe window state,
    committed atomically with the consumed offsets).
    """
    w = Windower(spec, fn, store=store)
    if windower_out is not None:
        windower_out.append(w)

    def on_batch(rdd: RDD, info: BatchInfo) -> list[Any]:
        return w.push(rdd.collect(), info)

    on_batch.windower = w
    return on_batch
