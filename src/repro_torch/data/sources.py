"""Data sources, trimmed to the §III detector and the §IV tilt series.

The counterpart of ``repro/data/sources.py``: a source is polled for
``(key, value)`` records; a replayable one also ``seek``s, so a restarted
pipeline can resume where its broker topic ends.
"""
from __future__ import annotations

import time
from typing import Any

import numpy as np

RecordKV = tuple[bytes | None, Any]


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
