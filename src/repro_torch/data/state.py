"""Durable window state, the counterpart of ``repro/data/state.py``:
``Windower`` accumulation that survives a restart.

The open window — records pulled off the broker but not yet fired — is
consumer state. Offsets are checkpointed after every micro-batch; left in
memory, the open window dies with the process after the offsets moved past
it, and every record consumed into it is lost. A :class:`WindowStateStore`
behind the windower closes that hole:

- :class:`InMemoryStateStore` — the degenerate path: same protocol, no I/O,
  no threads; a process death loses the open window.
- :class:`DurableStateStore` — the open window spilled to disk in the
  durable log's CRC frames (``u32 len | u32 crc | payload``, a recovery scan
  truncating torn tails): a **snapshot** frame holds the full state,
  **delta** frames append only what one commit changed. Every
  ``snapshot_every`` deltas the log is compacted — rewritten through a temp
  file, flush, fsync and ``os.replace`` as the last *committed* snapshot
  plus the new one — so it stays O(window), not O(stream).

Atomicity with the offset checkpoint is the point. The
:class:`~repro_torch.core.dstream.StreamingContext` first calls
:meth:`WindowStateStore.commit` (durable write, returns a *ref* = the epoch
persisted), then publishes ``(offsets, epoch, window refs)`` in its
checkpoint's single ``os.replace``. A crash between the two leaves the old
checkpoint pointing at the old ref; :meth:`WindowStateStore.restore` replays
state **up to the ref** and truncates the uncommitted tail, so the
interrupted batch — offsets *and* window pushes — replays together. The
files are the reference's byte for byte, so each package restores the
other's state.

Time-kind caveat: ``Windower`` buckets records relative to its first
batch's clock reading (``t0``). Restoring it across processes is only
meaningful under a clock comparable across restarts (wall clock, or an
injected domain clock); count windows (the paper's "every 512 frames")
restore exactly under any clock. The durable store registers the
reference's seven ``state_*`` instruments in the metrics registry
(:mod:`repro_torch.data.metrics`).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Protocol, runtime_checkable

from repro_torch.data.durable_log import (FSYNC_POLICIES, _REC_HEADER,
                                          frame_bytes, scan_frames)
from repro_torch.data.locktrace import new_lock
from repro_torch.data.metrics import get_registry
from repro_torch.data.transport import decode_message, encode_message
from repro_torch.utils import get_logger

log = get_logger(__name__)

_SNAP, _DELTA = "snap", "delta"
_STATE_FILE = "state.log"


@dataclass
class WindowState:
    """A :class:`~repro_torch.data.window.Windower`'s restartable state: the open
    window buffer — ``(value, ts, batch)`` triples — plus the counters that
    place it in the stream."""
    buf: list[tuple[Any, float, int]] = field(default_factory=list)
    evicted: int = 0                 # records dropped off the front
    t0: float | None = None          # stream epoch (time kind)
    windows_fired: int = 0

    @property
    def total_seen(self) -> int:
        """Records ever pushed = evicted + still buffered (monotonic)."""
        return self.evicted + len(self.buf)

    def copy(self) -> "WindowState":
        return WindowState(list(self.buf), self.evicted, self.t0,
                           self.windows_fired)


@runtime_checkable
class WindowStateStore(Protocol):
    """Persistence behind a windower. ``commit(epoch, state)`` durably
    records ``state`` and returns the *ref* to put in the offset checkpoint
    (the epoch persisted; an unchanged state may return the previous ref).
    ``restore(ref)`` returns the state committed at ``ref`` — discarding
    anything newer, which a crash left uncommitted — or ``None`` for an
    unknown/empty ref (fresh start)."""

    def commit(self, epoch: int, state: WindowState) -> int: ...

    def restore(self, ref: int | None) -> WindowState | None: ...

    def close(self) -> None: ...


class InMemoryStateStore:
    """Degenerate :class:`WindowStateStore`: holds the last committed state
    in memory. Same protocol, zero I/O, thread-free — the pre-existing
    behavior (a process death loses the open window), but round-trippable
    in-process for tests and as the baseline the durable store's overhead
    is measured against (``ingest/window_restore``)."""

    def __init__(self) -> None:
        self._ref: int | None = None
        self._state: WindowState | None = None
        self.commits = 0

    def commit(self, epoch: int, state: WindowState) -> int:
        self._state = state.copy()
        self._ref = epoch
        self.commits += 1
        return epoch

    def restore(self, ref: int | None) -> WindowState | None:
        if ref is None or ref != self._ref or self._state is None:
            return None
        return self._state.copy()

    def close(self) -> None:
        pass


def _encode_entry(kind: str, epoch: int, body: Any) -> bytes:
    return frame_bytes(b"".join(encode_message((kind, epoch, body))))


class DurableStateStore:
    """File-backed :class:`WindowStateStore` under ``path`` (a directory).

    One append-only ``state.log`` of CRC frames (the durable log's segment
    record format). Frame payloads are transport messages — ndarray window
    contents ride the zero-copy array encoding, and reads go through the
    restricted unpickler. Two entry kinds, epochs strictly increasing:

    - ``snap``  — full :class:`WindowState`,
    - ``delta`` — one commit's change against the previous: ``(dropped,
      tail, windows_fired, t0)``, replayed as ``buf = buf[dropped:] + tail``
      (evictions are always a prefix drop: the buffer is ts-ordered).

    On open, a recovery scan truncates any torn/corrupt tail (a crash
    mid-write costs at most the frame being written). :meth:`restore`
    additionally truncates frames *beyond the committed ref* — state the
    offset checkpoint never published. Compaction (every ``snapshot_every``
    deltas, and whenever a delta cannot express the change) rewrites the log
    as ``[snap(last committed ref), snap(new epoch)]`` via temp file +
    fsync + ``os.replace``: crash-safe on both sides of the caller's
    checkpoint write, and the file stays O(window), not O(stream).

    ``fsync`` policy is the durable log's: ``"always"`` / ``"interval"``
    (default) / ``"never"``. Like the durable log, a *process* crash loses
    nothing under any policy (writes are unbuffered); a *power loss* can
    lose frames the policy had not yet fsynced — and since the offset
    checkpoint always fsyncs, that is the one case where offsets can land
    ahead of window state. ``restore`` detects it (the checkpoint's ref has
    no frame) and warns; ``fsync="always"`` closes it. A state larger than
    the transport frame cap (~256 MiB serialized) is refused at commit with
    ``ValueError`` — the recovery scan would destroy it as corruption on
    the next open.
    """

    def __init__(self, path: str, snapshot_every: int = 16,
                 fsync: str = "interval", fsync_interval: float = 0.05
                 ) -> None:
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"fsync {fsync!r} not in {FSYNC_POLICIES}")
        if snapshot_every < 1:
            raise ValueError("snapshot_every must be >= 1")
        self.path = str(path)
        self.snapshot_every = snapshot_every
        self.fsync = fsync
        self.fsync_interval = fsync_interval
        self._lock = new_lock("DurableStateStore._lock")
        self._last_fsync = 0.0
        self._writer: Any = None
        # last committed (ref, state): the delta base, and what compaction
        # must keep restorable while the new epoch's checkpoint is in flight
        self._prev: tuple[int, WindowState] | None = None
        self._deltas_since_snap = 0
        self.snapshots = 0               # compactions (snapshot rewrites)
        self.deltas = 0                  # delta frames written
        self.recovered_frames = 0        # valid frames found on open
        self.truncated_bytes = 0         # torn/corrupt tail cut on open
        # unlabeled on purpose: the store path is a tmpdir in tests and
        # would explode label cardinality, so stores aggregate per process
        reg = get_registry()
        self._m_commits = reg.counter(
            "state_commits_total", help="window-state commits persisted")
        self._m_deltas = reg.counter(
            "state_delta_frames_total", help="delta frames appended")
        self._m_snapshots = reg.counter(
            "state_snapshots_total", help="snapshot compaction rewrites")
        self._m_restores = reg.counter(
            "state_restores_total", help="restore() replays")
        self._m_commit_s = reg.histogram(
            "state_commit_seconds", help="durable commit latency")
        self._m_restore_s = reg.histogram(
            "state_restore_seconds", help="restore replay latency")
        reg.gauge("state_log_bytes", help="window-state log size on disk",
                  callback=lambda: os.path.getsize(self._file))
        os.makedirs(self.path, exist_ok=True)
        self._file = os.path.join(self.path, _STATE_FILE)
        if os.path.exists(self._file):
            frames, valid_end = scan_frames(self._file)
            size = os.path.getsize(self._file)
            if valid_end < size:
                self.truncated_bytes = size - valid_end
                with open(self._file, "ab") as f:
                    f.truncate(valid_end)
                log.warning("window state %s: truncated %d torn/corrupt "
                            "tail bytes", self._file, self.truncated_bytes)
            self.recovered_frames = len(frames)
        self._open_writer()

    # -- file plumbing -----------------------------------------------------
    def _open_writer(self) -> None:
        if self._writer is not None:
            self._writer.close()
        # unbuffered: a killed process loses at most the frame being written
        self._writer = open(self._file, "ab", buffering=0)

    def _maybe_fsync(self) -> None:
        if self.fsync == "never":
            return
        now = time.monotonic()
        if self.fsync == "always" or \
                now - self._last_fsync >= self.fsync_interval:
            os.fsync(self._writer.fileno())
            self._last_fsync = now

    def _entries(self):
        """Decode every valid frame: ``[(end_pos, kind, epoch, body), ...]``.
        ``end_pos`` is the byte just past the frame — the truncation point
        that keeps everything up to and including it."""
        frames, _ = scan_frames(self._file)
        out = []
        with open(self._file, "rb") as f:
            for pos, length in frames:
                f.seek(pos + _REC_HEADER.size)
                payload = bytearray(length)
                f.readinto(payload)
                kind, epoch, body = decode_message(payload)
                out.append((pos + _REC_HEADER.size + length, kind, epoch,
                            body))
        return out

    # -- protocol ----------------------------------------------------------
    def commit(self, epoch: int, state: WindowState) -> int:
        t0 = time.perf_counter()
        with self._lock:
            delta = self._delta_against_prev(epoch, state)
            if delta == ():              # unchanged: keep the previous ref
                return self._prev[0]
            if delta is not None and \
                    self._deltas_since_snap < self.snapshot_every:
                self._writer.write(_encode_entry(_DELTA, epoch, delta))
                self._maybe_fsync()
                self._deltas_since_snap += 1
                self.deltas += 1
                self._m_deltas.inc()
            else:
                self._compact(epoch, state)
            self._prev = (epoch, state.copy())
            self._m_commits.inc()
            self._m_commit_s.observe(time.perf_counter() - t0)
            return epoch

    def restore(self, ref: int | None) -> WindowState | None:
        """Fold the log up to ``ref`` and truncate everything newer (written
        but never published by the offset checkpoint — the crash window this
        store exists to close). ``ref=None`` (no/fresh checkpoint) resets the
        log entirely."""
        # not t0: the replay loop below unpacks window-state t0 over it
        t_start = time.perf_counter()
        with self._lock:
            state: WindowState | None = None
            last: tuple[int, int] | None = None      # (end_pos, epoch)
            deltas_since = 0
            entries = self._entries()
            if ref is not None and not any(e == ref for _, _, e, _ in entries):
                # the checkpoint only ever names an epoch this store wrote,
                # so a missing ref frame means the frame never reached disk
                # (power loss outran the fsync policy) or the wrong state
                # directory — surface it instead of degrading silently
                log.warning(
                    "window state %s has no frame for checkpoint ref %s "
                    "(newest on disk: %s): restoring the newest earlier "
                    "state; records consumed after it may be lost from the "
                    "open window. fsync='always' closes this power-loss "
                    "window.", self._file, ref,
                    max((e for _, _, e, _ in entries), default=None))
            for end, kind, epoch, body in entries:
                if ref is None or epoch > ref:
                    break
                if kind == _SNAP:
                    buf, evicted, t0, wf = body
                    state = WindowState(list(buf), evicted, t0, wf)
                    deltas_since = 0
                elif kind == _DELTA and state is not None:
                    dropped, tail, wf, t0 = body
                    state.buf = state.buf[dropped:] + list(tail)
                    state.evicted += dropped
                    state.windows_fired, state.t0 = wf, t0
                    deltas_since += 1
                else:                    # delta with no base snapshot
                    log.warning("window state %s: delta at epoch %d has no "
                                "base snapshot; ignored", self._file, epoch)
                last = (end, epoch)
            good = last is not None and state is not None
            keep = last[0] if good else 0
            if keep < os.path.getsize(self._file):
                with open(self._file, "ab") as f:
                    f.truncate(keep)
                self._open_writer()
            self._deltas_since_snap = deltas_since if good else 0
            self._prev = (last[1], state.copy()) if good else None
            self._m_restores.inc()
            self._m_restore_s.observe(time.perf_counter() - t_start)
            return state.copy() if good else None

    def close(self) -> None:
        with self._lock:
            if self._writer is not None:
                if self.fsync != "never":
                    os.fsync(self._writer.fileno())
                self._writer.close()
                self._writer = None

    def __enter__(self) -> "DurableStateStore":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- delta / compaction ------------------------------------------------
    def _delta_against_prev(self, epoch: int, state: WindowState):
        """The change one commit made, or ``None`` when a delta cannot
        express it (first commit, or counters moved backwards — a caller-side
        rollback/restore we must not extrapolate across), or ``()`` when
        nothing changed at all."""
        if self._prev is None:
            return None
        pref, prev = self._prev
        appended = state.total_seen - prev.total_seen
        dropped = state.evicted - prev.evicted
        if (appended < 0 or dropped < 0 or epoch <= pref
                or state.windows_fired < prev.windows_fired
                or len(prev.buf) - dropped + appended != len(state.buf)):
            return None
        if appended == 0 and dropped == 0 \
                and state.windows_fired == prev.windows_fired \
                and state.t0 == prev.t0:
            return ()
        # A window that fires in this commit's own batch can evict records
        # that batch pushed (a batch that does not divide the window): then
        # more were appended than are buffered, and every buffered record is
        # new. The reference slices from ``len - appended`` and, negative,
        # keeps only the last record (ROADMAP Queue 3).
        tail = (state.buf[max(0, len(state.buf) - appended):] if appended
                else [])
        return (dropped, tail, state.windows_fired, state.t0)

    def _compact(self, epoch: int, state: WindowState) -> None:
        """Rewrite the log as at most two snapshots: the last *committed*
        epoch (the checkpoint may still point at it if the caller crashes
        before publishing ``epoch``) and the new one. Temp file + fsync +
        ``os.replace``: readers of either epoch always find a valid log."""
        tmp = self._file + ".tmp"
        with open(tmp, "wb") as f:
            if self._prev is not None:
                pref, prev = self._prev
                f.write(_encode_entry(_SNAP, pref,
                                      (prev.buf, prev.evicted, prev.t0,
                                       prev.windows_fired)))
            f.write(_encode_entry(_SNAP, epoch,
                                  (state.buf, state.evicted, state.t0,
                                   state.windows_fired)))
            f.flush()
            if self.fsync != "never":
                os.fsync(f.fileno())
        os.replace(tmp, self._file)
        self._open_writer()
        self._deltas_since_snap = 0
        self.snapshots += 1
        self._m_snapshots.inc()
