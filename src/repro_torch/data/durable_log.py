"""Durable, file-backed :class:`~repro_torch.core.broker.PartitionLog`, the
counterpart of ``repro/data/durable_log.py``.

An append-only log of length-prefixed, CRC-checked record frames in
**segment files** on disk, with an in-memory offset index rebuilt by a
**recovery scan** every time the log opens. Layout of one partition
directory::

    p0000/
      00000000.seg     record frames, appended in offset order
      00000001.seg     ... next segment after ``segment_bytes`` rolls over

Each record frame is ``u32 length | u32 crc32 | payload`` where the payload
is the message encoding of ``(key, value, timestamp)``
(:mod:`repro_torch.data.transport`): the same bytes the reference writes, so
either package reopens the other's log.

Recovery contract: on open, every segment is scanned front to back and each
frame's CRC re-verified. The scan stops at the first frame that does not
hold — a torn tail from a killed producer, a truncated file, a flipped bit —
and the log **truncates to the last valid frame boundary** (later segments
are set aside as ``*.orphan``, never silently re-entered). What survives is
always a dense, garbage-free prefix of what was appended. Corruption under a
live log raises :class:`LogCorruptionError` on read; it never reads as an
empty or garbage record.

``fsync`` policy trades durability for append latency:

- ``"always"``   — fsync after every append/append_many (power-loss safe),
- ``"interval"`` — fsync at most every ``fsync_interval`` seconds (default;
  bounded power-loss window, process crashes lose nothing),
- ``"never"``    — leave flushing to the OS (process crashes still lose
  nothing: writes are unbuffered, only power loss is exposed).

Creating a segment (a roll) and renaming one aside (``*.orphan``) are
directory mutations, so under ``"always"``/``"interval"`` the partition
directory is fsynced after each; ``"never"`` skips it.

The CRC frame format doubles as the **replication wire format**: a follower
(:class:`~repro_torch.data.replication.ReplicaFollower`) pulls committed
frames with :meth:`DurablePartitionLog.read_frames` — raw header and payload
bytes, verbatim — re-verifies each CRC on its side of the socket and appends
them byte-identical with :meth:`DurablePartitionLog.append_frames`. Offsets
stay dense and equal on both logs by construction.

:class:`DurableLogFactory` adapts this to ``Broker(log_factory=...)``: the
broker passes ``(topic, partition)`` to factories that accept them, and the
factory maps each onto a stable directory under its root, so a restarted
broker that calls :meth:`DurableLogFactory.restore` reopens the same logs
and replays every committed record to fresh subscribers.
"""
from __future__ import annotations

import os
import struct
import time
import zlib
from typing import Any, Sequence

from repro_torch.core.broker import Broker, Record
from repro_torch.data.locktrace import new_rlock
from repro_torch.data.transport import (MAX_FRAME_BYTES, decode_message,
                                        encode_message)
from repro_torch.utils import get_logger

log = get_logger(__name__)

_REC_HEADER = struct.Struct(">II")     # payload length | crc32 of payload
_SEGMENT_SUFFIX = ".seg"
FSYNC_POLICIES = ("always", "interval", "never")


class LogCorruptionError(RuntimeError):
    """A record frame failed its CRC (or header) *after* recovery accepted
    it — disk corruption under a live log. Never returns garbage instead."""


def frame_bytes(payload: bytes) -> bytes:
    """One CRC frame, ``u32 length | u32 crc32 | payload`` — the segment
    record format, shared with :mod:`repro_torch.data.state`. Refuses
    payloads past ``MAX_FRAME_BYTES``: the recovery scan treats larger
    lengths as corruption, so such a frame would commit and then be
    destroyed (with everything after it) on the next open."""
    if len(payload) > MAX_FRAME_BYTES:
        raise ValueError(
            f"record of {len(payload)} bytes exceeds the "
            f"{MAX_FRAME_BYTES}-byte durable-log record limit")
    return _REC_HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def scan_frames(path: str) -> tuple[list[tuple[int, int]], int]:
    """Recovery scan over one frame file: validate every frame front to back,
    stopping at the first that does not hold (torn tail, truncated file,
    insane length, CRC mismatch). Returns ``([(frame_pos, payload_len), ...],
    valid_end)`` — callers truncate the file at ``valid_end`` to cut the
    torn/corrupt tail and may re-read any listed frame at ``frame_pos``."""
    frames: list[tuple[int, int]] = []
    size = os.path.getsize(path)
    pos = 0
    with open(path, "rb") as f:
        while pos + _REC_HEADER.size <= size:
            length, crc = _REC_HEADER.unpack(f.read(_REC_HEADER.size))
            if length > MAX_FRAME_BYTES or \
                    pos + _REC_HEADER.size + length > size:
                break                      # torn tail / insane length
            payload = f.read(length)
            if zlib.crc32(payload) != crc:
                break                      # corrupt frame
            frames.append((pos, length))
            pos += _REC_HEADER.size + length
    return frames, pos


class DurablePartitionLog:
    """File-backed append-only log for one (topic, partition).

    Implements the :class:`~repro_torch.core.broker.PartitionLog` protocol
    (``append``/``read``/``end_offset``) plus ``append_many`` — the batched
    append :meth:`Broker.produce_many` uses for one write + one fsync per
    batch. Thread-safe; offsets are dense from 0.
    """

    def __init__(self, path: str, segment_bytes: int = 64 * 1024 * 1024,
                 fsync: str = "interval", fsync_interval: float = 0.05
                 ) -> None:
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"fsync {fsync!r} not in {FSYNC_POLICIES}")
        self.path = path
        self.segment_bytes = segment_bytes
        self.fsync = fsync
        self.fsync_interval = fsync_interval
        self._lock = new_rlock("DurablePartitionLog._lock")
        # offset -> (segment id, byte position, payload length)
        self._index: list[tuple[int, int, int]] = []
        self._readers: dict[int, int] = {}   # segment id -> read fd
        self._writer: Any = None
        self._active_seg = 0
        self._active_size = 0
        self._last_fsync = 0.0
        self.recovered_records = 0         # valid frames found on open
        self.truncated_bytes = 0           # torn/corrupt tail cut on open
        self.orphaned_segments = 0         # segments after a corrupt one
        os.makedirs(path, exist_ok=True)
        self._recover()

    # -- files -------------------------------------------------------------
    def _seg_path(self, seg_id: int) -> str:
        return os.path.join(self.path, f"{seg_id:08d}{_SEGMENT_SUFFIX}")

    def _reader_fd(self, seg_id: int) -> int:
        with self._lock:
            fd = self._readers.get(seg_id)
            if fd is None:
                fd = os.open(self._seg_path(seg_id), os.O_RDONLY)
                self._readers[seg_id] = fd
            return fd

    def _pread(self, fd: int, nbytes: int, pos: int) -> bytearray:
        """Positionless read into a fresh *writable* buffer (zero-copy array
        decode needs mutability). ``pread`` carries its own offset, so
        concurrent readers never race a shared file position — and never
        need the appender lock."""
        buf = bytearray(nbytes)
        view = memoryview(buf)
        done = 0
        while done < nbytes:
            got = os.preadv(fd, [view[done:]], pos + done)
            if got <= 0:
                raise LogCorruptionError(
                    f"{self.path}: short read at pos {pos} "
                    f"({done}/{nbytes} bytes)")
            done += got
        return buf

    def _fsync_dir(self) -> None:
        """Flush the partition *directory* entry (segment create/rename) —
        without it a power loss can undo the rename/creation even though the
        file contents were fsynced. Skipped under ``fsync="never"``."""
        if self.fsync == "never":
            return
        fd = os.open(self.path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _open_writer(self, seg_id: int) -> None:
        if self._writer is not None:
            self._writer.close()
        path = self._seg_path(seg_id)
        created = not os.path.exists(path)
        # unbuffered: every append is a real write(2), so a killed process
        # loses at most the frame being written, never a buffered batch
        self._writer = open(path, "ab", buffering=0)
        self._active_seg = seg_id
        self._active_size = self._writer.tell()
        if created:
            self._fsync_dir()

    # -- recovery ----------------------------------------------------------
    def _recover(self) -> None:
        seg_ids = sorted(
            int(name[:-len(_SEGMENT_SUFFIX)])
            for name in os.listdir(self.path)
            if name.endswith(_SEGMENT_SUFFIX))
        corrupt_at: int | None = None
        for seg_id in seg_ids:
            if corrupt_at is not None:
                self._orphan(seg_id)
                continue
            if not self._scan_segment(seg_id):
                corrupt_at = seg_id
        self.recovered_records = len(self._index)
        active = (corrupt_at if corrupt_at is not None
                  else (seg_ids[-1] if seg_ids else 0))
        self._open_writer(active)
        if self.truncated_bytes or self.orphaned_segments:
            log.warning(
                "recovered %s: %d records, truncated %d bytes, "
                "%d segments orphaned", self.path, self.recovered_records,
                self.truncated_bytes, self.orphaned_segments)

    def _scan_segment(self, seg_id: int) -> bool:
        """Validate every frame; truncate at the first that does not hold.
        Returns True if the whole segment was clean."""
        path = self._seg_path(seg_id)
        size = os.path.getsize(path)
        frames, valid_end = scan_frames(path)
        self._index.extend((seg_id, pos, length) for pos, length in frames)
        if valid_end < size:
            self.truncated_bytes += size - valid_end
            with open(path, "ab") as f:
                f.truncate(valid_end)
            return False
        return True

    def _orphan(self, seg_id: int) -> None:
        """A segment *after* a corrupt one cannot rejoin the offset space
        (offsets must stay dense); set it aside rather than delete it."""
        src = self._seg_path(seg_id)
        dst = src + ".orphan"
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = f"{src}.orphan{n}"
        os.rename(src, dst)
        self._fsync_dir()
        self.orphaned_segments += 1

    # -- append ------------------------------------------------------------
    @staticmethod
    def _frame(key: bytes | None, value: Any, timestamp: float) -> bytes:
        return frame_bytes(b"".join(encode_message((key, value, timestamp))))

    def _maybe_roll(self) -> None:
        if self._active_size >= self.segment_bytes and self._active_size > 0:
            self._open_writer(self._active_seg + 1)

    def _maybe_fsync(self) -> None:
        if self.fsync == "never":
            return
        now = time.monotonic()
        if self.fsync == "always" or \
                now - self._last_fsync >= self.fsync_interval:
            os.fsync(self._writer.fileno())
            self._last_fsync = now

    def _append_frames(self, frames: list[bytes],
                       lengths: list[int]) -> list[int]:
        self._maybe_roll()
        pos = self._active_size
        base = len(self._index)
        offsets = list(range(base, base + len(frames)))
        blob = b"".join(frames)
        self._writer.write(blob)
        for length in lengths:
            self._index.append((self._active_seg, pos,
                                length - _REC_HEADER.size))
            pos += length
        self._active_size += len(blob)
        self._maybe_fsync()
        return offsets

    def append(self, key: bytes | None, value: Any,
               timestamp: float = 0.0) -> int:
        frame = self._frame(key, value, timestamp)
        with self._lock:
            return self._append_frames([frame], [len(frame)])[0]

    def append_many(self, pairs: Sequence[tuple], timestamp: float = 0.0
                    ) -> list[int]:
        """Batched append: one write(2) + at most one fsync for the whole
        batch — the disk half of ``produce_many``'s amortization."""
        frames = [self._frame(k, v, timestamp) for k, v in pairs]
        if not frames:
            return []
        with self._lock:
            return self._append_frames(frames, [len(f) for f in frames])

    # -- read --------------------------------------------------------------
    def _index_slice(self, start: int,
                     until: int) -> tuple[int, list[tuple[int, int, int]]]:
        """Snapshot the index entries for ``[start, min(until, end))`` under
        the lock. The disk I/O happens *outside* it: a slow or cold-cache
        reader (a catching-up replication follower is exactly that) must not
        stall hot-path appends, and committed index entries are immutable —
        frames are never rewritten in place, only appended after them."""
        with self._lock:
            begin = max(start, 0)
            end = min(until, len(self._index))
            return begin, self._index[begin:end]

    def _frame_at(self, offset: int, seg_id: int, pos: int,
                  length: int) -> bytearray:
        """Read + CRC-verify one whole frame (header included) lock-free."""
        raw = self._pread(self._reader_fd(seg_id),
                          _REC_HEADER.size + length, pos)
        stored_len, crc = _REC_HEADER.unpack_from(raw)
        if stored_len != length or \
                zlib.crc32(memoryview(raw)[_REC_HEADER.size:]) != crc:
            raise LogCorruptionError(
                f"{self.path}: offset {offset} failed its CRC "
                "(on-disk corruption under a live log)")
        return raw

    def read(self, start: int, until: int) -> list[Record]:
        begin, entries = self._index_slice(start, until)
        out: list[Record] = []
        for i, (seg_id, pos, length) in enumerate(entries):
            offset = begin + i
            raw = self._frame_at(offset, seg_id, pos, length)
            # slice off the header; the buffer stays writable (zero-copy
            # arrays decoded over it remain mutable downstream)
            key, value, ts = decode_message(memoryview(raw)[_REC_HEADER.size:])
            out.append(Record(key, value, offset, ts))
        return out

    def read_frames(self, start: int, until: int,
                    max_bytes: int = 4 * 1024 * 1024
                    ) -> tuple[bytes, list[int], int]:
        """Replication cursor: the segments' bytes for offsets ``[start,
        min(until, end))`` as one contiguous blob plus the per-frame sizes
        (header included), capped at ``max_bytes`` a call (at least one
        frame whenever any is available). Returns ``(blob, lengths,
        next_offset)``. CRCs are *not* checked here: the follower
        re-verifies every frame before it appends (:meth:`append_frames`),
        so a corrupt byte still cannot enter the replica's offset space,
        and the primary's serving path stays a handful of preads."""
        begin, entries = self._index_slice(start, until)
        lengths: list[int] = []
        total = 0
        for _, _, length in entries:
            size = _REC_HEADER.size + length
            if lengths and total + size > max_bytes:
                break
            lengths.append(size)
            total += size
        entries = entries[:len(lengths)]
        chunks: list[bytes] = []
        i = 0
        while i < len(entries):
            # frames are append-only, so consecutive index entries in one
            # segment are physically contiguous: coalesce the whole span
            # into one pread instead of one syscall a frame (a catching-up
            # follower pulls tens of thousands at a time)
            seg_id, pos, _ = entries[i]
            j, span = i, 0
            while j < len(entries) and entries[j][0] == seg_id and \
                    entries[j][1] == pos + span:
                span += lengths[j]
                j += 1
            chunks.append(self._pread(self._reader_fd(seg_id), span, pos))
            i = j
        return b"".join(chunks), lengths, begin + len(entries)

    def append_frames(self, frames: Sequence[bytes]) -> list[int]:
        """Follower-side replication append: verify and append pre-framed
        record bytes *verbatim* (no decode and re-encode: the CRC frame is
        the wire format). A frame whose header or CRC does not hold fails
        the whole batch before anything is appended: a corrupt frame must
        never enter the offset space."""
        checked: list[bytes] = []
        for frame in frames:
            frame = bytes(frame)
            if len(frame) < _REC_HEADER.size:
                raise ValueError(
                    f"replicated frame of {len(frame)} bytes is shorter "
                    "than its header")
            length, crc = _REC_HEADER.unpack_from(frame)
            if length != len(frame) - _REC_HEADER.size or \
                    length > MAX_FRAME_BYTES or \
                    zlib.crc32(memoryview(frame)[_REC_HEADER.size:]) != crc:
                raise ValueError(
                    "replicated frame failed its CRC/length check "
                    "(corrupted in transit; refusing the batch)")
            checked.append(frame)
        if not checked:
            return []
        with self._lock:
            return self._append_frames(checked, [len(f) for f in checked])

    def end_offset(self) -> int:
        with self._lock:
            return len(self._index)

    # -- lifecycle ---------------------------------------------------------
    @property
    def segments(self) -> int:
        with self._lock:
            return len({seg for seg, _, _ in self._index}) or 1

    def close(self) -> None:
        with self._lock:
            if self._writer is not None:
                if self.fsync != "never":
                    os.fsync(self._writer.fileno())
                self._writer.close()
                self._writer = None
            for fd in self._readers.values():
                os.close(fd)
            self._readers.clear()

    def __enter__(self) -> "DurablePartitionLog":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class DurableLogFactory:
    """``Broker(log_factory=DurableLogFactory(root))``: one
    :class:`DurablePartitionLog` per (topic, partition) under ``root``.

    The broker passes ``topic``/``partition`` keywords (it probes the factory
    signature), and the factory maps them to ``root/<topic>/p<partition>`` —
    a *stable* location, so re-creating the topic after a restart reopens the
    same segments and recovers every record. :meth:`restore` re-creates all
    topics found on disk on a fresh broker in one call.
    """

    def __init__(self, root: str, **log_kwargs: Any) -> None:
        self.root = str(root)
        self._log_kwargs = log_kwargs
        os.makedirs(self.root, exist_ok=True)

    def __call__(self, topic: str, partition: int) -> DurablePartitionLog:
        if (not topic or os.sep in topic or (os.altsep or "/") in topic
                or topic in (".", "..") or "\x00" in topic):
            raise ValueError(f"topic {topic!r} is not a safe directory name")
        path = os.path.join(self.root, topic, f"p{partition:04d}")
        return DurablePartitionLog(path, **self._log_kwargs)

    def topics_on_disk(self) -> dict[str, int]:
        """Map of topic -> partition count found under ``root``."""
        found: dict[str, int] = {}
        for topic in sorted(os.listdir(self.root)):
            tdir = os.path.join(self.root, topic)
            if not os.path.isdir(tdir):
                continue
            parts = [name for name in os.listdir(tdir)
                     if name.startswith("p") and name[1:].isdigit()
                     and os.path.isdir(os.path.join(tdir, name))]
            if parts:
                found[topic] = max(int(p[1:]) for p in parts) + 1
        return found

    def restore(self, broker: Broker) -> list[str]:
        """Re-create every topic found on disk on a (fresh) broker — the
        restart path: records recovered by the per-partition scans become
        readable at their original offsets, so a new subscriber replays the
        full committed history."""
        topics = self.topics_on_disk()
        for topic, partitions in topics.items():
            broker.create_topic(topic, partitions)
        return sorted(topics)
