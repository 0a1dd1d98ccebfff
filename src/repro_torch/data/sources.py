"""Data sources, the counterpart of ``repro/data/sources.py``.

A :class:`Source` is anything that can be polled for ``(key, value)``
records. Replayable sources also ``seek(offset)``, so a restarted pipeline
can resume where its broker topic ends.

- :class:`DetectorSource` — the paper §III ptychography detector, fronting
  the frame simulator in ``apps/ptycho/sim.py``.
- :class:`ProjectionSource` — the paper §IV TEM tilt series, one sinogram
  slice per record.
- :class:`FileReplaySource` — deterministic replay of an NPZ or JSONL
  capture (DELTA's generator-from-disk idiom).
- :class:`SyntheticRateSource` — a clocked record generator for load tests
  and backpressure experiments.
- :class:`TopicSource` — re-ingest an existing broker topic, which is how
  multi-stage pipelines chain.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core.broker import Broker, OffsetRange
from repro_torch.data.codec import maybe_decode

RecordKV = tuple[bytes | None, Any]


@runtime_checkable
class Source(Protocol):
    """Pollable record source. ``poll`` returns at most ``max_records``
    ``(key, value)`` pairs; an empty list means "nothing available *now*",
    which is final only once ``exhausted`` is true."""

    def poll(self, max_records: int) -> list[RecordKV]: ...

    @property
    def exhausted(self) -> bool: ...


@runtime_checkable
class ReplayableSource(Source, Protocol):
    """A source whose records are a deterministic indexed sequence, so
    ``seek(n)`` repositions to the n-th record (restart/resume support)."""

    def seek(self, offset: int) -> None: ...

    @property
    def position(self) -> int: ...


class SequenceSource:
    """Base for replayable sources backed by an indexable record sequence.

    Subclasses implement ``__len__`` and ``record_at(i)``. With
    ``interval > 0``, records are released no faster than one per
    ``interval`` seconds (the acquisition-rate simulation)."""

    def __init__(self, interval: float = 0.0) -> None:
        self._cursor = 0
        self._interval = float(interval)
        self._clock_start: float | None = None
        self._released = 0     # pacing budget consumed (independent of seek)

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def record_at(self, i: int) -> RecordKV:  # pragma: no cover - abstract
        raise NotImplementedError

    def _allowed_now(self, want: int) -> int:
        if self._interval <= 0:
            return want
        now = time.monotonic()
        if self._clock_start is None:
            self._clock_start = now
        due = int((now - self._clock_start) / self._interval) + 1
        return max(0, min(want, due - self._released))

    def poll(self, max_records: int) -> list[RecordKV]:
        end = min(len(self), self._cursor + self._allowed_now(max_records))
        out = [self.record_at(i) for i in range(self._cursor, end)]
        self._released += end - self._cursor
        self._cursor = end
        return out

    @property
    def exhausted(self) -> bool:
        return self._cursor >= len(self)

    @property
    def position(self) -> int:
        return self._cursor

    def seek(self, offset: int) -> None:
        if offset < 0 or offset > len(self):
            raise ValueError(f"seek({offset}) outside [0, {len(self)}]")
        self._cursor = offset


class DetectorSource(SequenceSource):
    """Ptychography detector (paper §III): frames from the simulator in scan
    order. By default the value is the frame index (the solver indexes the
    measurement set on the device); with ``emit_frames=True`` each value is
    ``(index, magnitude_frame)``, read from the problem's host copy."""

    def __init__(self, problem: Any, max_frames: int | None = None,
                 frame_interval: float = 0.0,
                 emit_frames: bool = False) -> None:
        super().__init__(interval=frame_interval)
        self.problem = problem
        self._n = problem.num_frames if max_frames is None else min(
            max_frames, problem.num_frames)
        self._emit_frames = emit_frames

    def __len__(self) -> int:
        return self._n

    def record_at(self, i: int) -> RecordKV:
        key = f"frame-{i:06d}".encode()
        if self._emit_frames:
            return key, (i, np.asarray(self.problem.magnitudes_host[i]))
        return key, i


class ProjectionSource(SequenceSource):
    """TEM tilt series (paper §IV): one record per sinogram slice, keyed
    ``slice-%06d``, with ``value = (slice_index, sinogram_row)`` read from
    a host array."""

    def __init__(self, sinogram: np.ndarray, interval: float = 0.0) -> None:
        super().__init__(interval=interval)
        self._sino = np.asarray(sinogram)

    def __len__(self) -> int:
        return len(self._sino)

    def record_at(self, i: int) -> RecordKV:
        return f"slice-{i:06d}".encode(), (i, self._sino[i])


class FileReplaySource(SequenceSource):
    """Replay a capture from disk with deterministic ordering.

    ``.npz``: one record per array, ordered by sorted key name.
    ``.jsonl``: one record per line, file order, value = parsed object.

    This is DELTA's generator-from-disk idiom: the instrument is replaced by
    a file, everything downstream is unchanged.
    """

    def __init__(self, path: str, interval: float = 0.0) -> None:
        super().__init__(interval=interval)
        self.path = path
        if path.endswith(".npz"):
            with np.load(path) as z:
                self._keys = sorted(z.files)
                self._values = [np.asarray(z[k]) for k in self._keys]
        elif path.endswith(".jsonl"):
            with open(path) as f:
                lines = [ln for ln in f if ln.strip()]
            self._keys = [f"line-{i:06d}" for i in range(len(lines))]
            self._values = [json.loads(ln) for ln in lines]
        else:
            raise ValueError(f"unsupported replay format: {path!r} "
                             "(want .npz or .jsonl)")

    def __len__(self) -> int:
        return len(self._keys)

    def record_at(self, i: int) -> RecordKV:
        return self._keys[i].encode(), self._values[i]


class SyntheticRateSource(SequenceSource):
    """Clocked generator: emits ``value_fn(i)`` at ``rate`` records/second,
    ``total`` records in all (``None`` = unbounded). The load-test knob for
    the ingest runtime: crank ``rate`` past what the pipeline sustains and
    watch the backpressure policy engage."""

    UNPACED_RATE = 1e6     # rates at/above this skip the pacing clock

    def __init__(self, rate: float, total: int | None = None,
                 value_fn: Callable[[int], Any] | None = None) -> None:
        if rate <= 0:
            raise ValueError("rate must be > 0")
        super().__init__(
            interval=0.0 if rate >= self.UNPACED_RATE else 1.0 / rate)
        self._total = total
        self._value_fn = value_fn or (lambda i: i)

    def __len__(self) -> int:
        return self._total if self._total is not None else (1 << 62)

    def record_at(self, i: int) -> RecordKV:
        return f"rec-{i:09d}".encode(), self._value_fn(i)


class TopicSource:
    """Re-ingest an existing broker topic: the chaining primitive for
    multi-stage pipelines (stage 1's :class:`~repro_torch.data.sinks.TopicSink`
    becomes stage 2's source).

    Polls partitions in order from per-partition offsets; codec'd values
    are decoded here, at the consume boundary. ``exhausted`` is
    never true for a live topic unless ``stop_at_end`` is set, in which case
    the source drains the topic as of each poll. ``seek(n)`` takes a *total*
    record position (the same contract ``position`` reports), distributed
    over partitions in drain order against current end offsets — exact for
    bulk polls over a quiescent topic, approximate if the log grew since.
    """

    def __init__(self, broker: Broker, topic: str,
                 stop_at_end: bool = False) -> None:
        self.broker = broker
        self.topic = topic
        self.stop_at_end = stop_at_end
        self._offsets = [0] * broker.num_partitions(topic)

    def poll(self, max_records: int) -> list[RecordKV]:
        # codec'd topics decode here, at the consume boundary, so re-ingest
        # stages see the same values a subscriber would — and a chained
        # stage's own codec re-encodes on its flush
        out: list[RecordKV] = []
        for p, start in enumerate(self._offsets):
            if len(out) >= max_records:
                break
            until = min(self.broker.end_offset(self.topic, p),
                        start + max_records - len(out))
            if until <= start:
                continue
            recs = self.broker.read(OffsetRange(self.topic, p, start, until))
            out.extend((r.key, maybe_decode(r.value)) for r in recs)
            self._offsets[p] = until
        return out

    @property
    def exhausted(self) -> bool:
        if not self.stop_at_end:
            return False
        return all(off >= self.broker.end_offset(self.topic, p)
                   for p, off in enumerate(self._offsets))

    @property
    def position(self) -> int:
        return sum(self._offsets)

    def seek(self, offset: int) -> None:
        remaining = offset
        for p in range(len(self._offsets)):
            take = min(remaining, self.broker.end_offset(self.topic, p))
            self._offsets[p] = take
            remaining -= take


def save_npz_capture(path: str, records: Sequence[tuple[str, np.ndarray]]) -> str:
    """Write an NPZ capture that :class:`FileReplaySource` replays in the
    given order (keys are prefixed with their index to pin the sort)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {f"{i:06d}-{name}": np.asarray(v)
              for i, (name, v) in enumerate(records)}
    np.savez(path, **arrays)
    return path
