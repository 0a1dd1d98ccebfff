"""The broker transport, the counterpart of ``repro/data/transport.py``:
partition logs served over sockets, byte for byte the reference's wire
format, so a reference client works against the port's server and the
reverse.

The paper puts the detector and the compute cluster on different machines,
joined by Kafka (Fig. 7); its future-work item is a ZeroMQ-style interface.

- :class:`BrokerServer` owns a local :class:`~repro_torch.core.broker.Broker`
  and serves its surface (``create_topic``/``produce``/``produce_many``/
  ``read``/``end_offset``/``commit``/…) over TCP or a Unix domain socket,
  one handler thread per client connection.
- :class:`RemoteBroker` is a client with the same duck type as
  :class:`~repro_torch.core.broker.Broker`, so ``IngestRunner``,
  ``StreamingContext`` and ``TopicSource`` work across processes and hosts
  unchanged. It reconnects after a server restart and bounds its retries.

Wire format: every message is one *frame* — a fixed header ``magic(2B) |
length(u32) | crc32(u32)`` followed by ``length`` payload bytes. A frame
whose magic, length or checksum does not hold is *rejected*, not guessed
at: a torn or corrupt write kills that connection and the client
re-establishes and retries. Retries give at-least-once delivery (a
``produce``/``produce_many`` whose ack was lost may be re-sent — the *whole
batch*, in the batched case); the idempotent-by-key sinks restore
exactly-once downstream.

The frame payload carries a one-byte *message kind*:

- ``P`` — a restricted-pickle blob (containers, scalars, broker record
  types; see :func:`register_safe`).
- ``A`` — an *array frame*: the skeleton is still restricted pickle, but
  every contiguous ndarray's bytes travel as raw out-of-band buffers after
  it (pickle protocol 5 buffer references). Arrays skip pickling on encode
  — the buffers are sent straight from the array memory — and on decode
  they are views over the received frame buffer.
- ``S`` — a *shared-memory frame*: the same split as ``A``, but the buffer
  bytes live in a server-owned ``multiprocessing.shared_memory`` segment
  and only ``(offset, length)`` descriptors cross the socket. Same-host
  only, negotiated per connection by a ``hello`` exchange (hostname and
  kernel boot id must match); requests fall back to ``A`` frames when the
  negotiation fails, :data:`USE_SHM_FRAMES` is off, or the server declines
  a lease. Segments are pooled per connection, ref-counted against the
  arrays decoded out of them, and unlinked by the *server* the moment the
  connection drops — a SIGKILLed producer strands nothing in ``/dev/shm``.
  The port names its segments ``reprotorchshm_<pid>_<n>``, apart from the
  reference's ``reproshm_``, so both packages' servers share a process.

The durable log (:mod:`repro_torch.data.durable_log`) and the window-state
store (:mod:`repro_torch.data.state`) write the same message payloads inside
their CRC frames. Reads go through the restricted unpickler, which resolves
only the globals on the allow-list: a log holds frame ids, keys and numpy
arrays, never a device tensor, which the list refuses.

Delivery and ordering match the in-process broker: per-partition total
order (one handler thread executes one client's requests in order; the log
append itself is locked), no order across partitions or across clients.
The server also carries the consumer-group protocol
(:mod:`repro_torch.data.groups`) and the replication and HA ops
(:mod:`repro_torch.data.replication`), whose errors cross the wire typed.
Locks come from :mod:`repro_torch.data.locktrace`.
"""
from __future__ import annotations

import io
import itertools
import os
import pickle
import socket
import struct
import threading
import time
import weakref
import zlib
from multiprocessing import resource_tracker, shared_memory
from typing import Any, Callable

import numpy as np

from repro_torch.core.broker import (  # noqa: F401
    Broker, BrokerFencedError, NotPrimaryError, OffsetRange, Record)
from repro_torch.data.locktrace import new_lock, new_rlock
from repro_torch.data.metrics import get_registry
from repro_torch.utils import get_logger

log = get_logger(__name__)

# -- framing -----------------------------------------------------------------

MAGIC = b"\xabK"                       # 2 bytes: frame sync marker
_HEADER = struct.Struct(">2sII")       # magic | payload length | crc32
MAX_FRAME_BYTES = 256 * 1024 * 1024    # reject absurd lengths before alloc

# Message kinds: first payload byte. P = restricted pickle; A = array frame
# (pickled skeleton + raw out-of-band ndarray buffers, layout below);
# S = shared-memory frame (buffers live in a shm segment, only descriptors
# cross the socket).
KIND_PICKLE = b"P"
KIND_ARRAY = b"A"
KIND_SHM = b"S"
# Array frame body, after the kind byte:
#   u32 skeleton_len | u32 nbufs | nbufs x u64 buf_len | skeleton | buf0 ...
_ARRAY_HEADER = struct.Struct(">II")
# Shared-memory frame body, after the kind byte:
#   u32 skeleton_len | u32 nbufs | u16 name_len | name |
#   nbufs x (u64 offset | u64 length) | skeleton
_SHM_HEADER = struct.Struct(">IIH")
_SHM_DESC = struct.Struct(">QQ")

# Flip to False to force every ndarray through the pickle path —
# benchmarks use this to price the array fast path.
USE_ARRAY_FRAMES = True

# Kill switch for the shared-memory fast path: False refuses it on both
# sides of the hello negotiation, so every frame degrades to 'A'/'P'.
USE_SHM_FRAMES = True

# Per-connection cap on pooled shm segment bytes; past it shm_alloc declines
# and the client falls back to 'A' frames (a safety valve, not an error).
SHM_POOL_MAX_BYTES = 256 * 1024 * 1024
_SHM_SEGMENT_MIN = 1 << 20             # round leases up so segments recycle
_SHM_PREFIX = "reprotorchshm"          # /dev/shm names: leak tests grep this

# Address = ("host", port) for TCP, or "path.sock" for a Unix domain socket.
Address = "tuple[str, int] | str"


class TransportError(RuntimeError):
    """Client gave up: retries exhausted or the server returned a non-broker
    error."""


class FrameError(TransportError):
    """The byte stream is not a well-formed frame (bad magic, bad checksum,
    torn write, undecodable message). The connection carrying it must be
    dropped."""


_HAVE_SENDMSG = hasattr(socket.socket, "sendmsg")
_IOV_BATCH = 512                       # stay safely under IOV_MAX (1024)


def _sendmsg_all(sock: socket.socket, parts) -> None:
    """``sendall`` for a list of buffers via scatter-gather ``sendmsg`` (one
    syscall per ~512 buffers, resuming partial sends mid-buffer) — the parts
    are never concatenated, so nothing here is O(frame) beyond the kernel
    copy itself. Falls back to serial ``sendall`` without ``sendmsg``."""
    views = [(p if isinstance(p, memoryview) else memoryview(p)).cast("B")
             for p in parts]
    if not _HAVE_SENDMSG:               # pragma: no cover - non-POSIX
        for v in views:
            sock.sendall(v)
        return
    while views:
        sent = sock.sendmsg(views[:_IOV_BATCH])
        while views and sent >= views[0].nbytes:
            sent -= views[0].nbytes
            views.pop(0)
        if sent:                        # partial buffer: resume mid-view
            views[0] = views[0][sent:]


def send_frame(sock: socket.socket, payload) -> None:
    """Write one length-prefixed, checksummed frame of raw ``payload`` bytes."""
    if len(payload) > MAX_FRAME_BYTES:
        # fail fast on the sending side: the receiver would reject it anyway,
        # and a retry loop can never make an oversized payload fit
        raise FrameError(
            f"frame length {len(payload)} exceeds {MAX_FRAME_BYTES}")
    header = _HEADER.pack(MAGIC, len(payload), zlib.crc32(payload))
    # header and payload as two iovecs of one sendmsg — never `header +
    # payload`, which copied the whole payload (up to 256 MiB) to prepend
    # 10 bytes
    _sendmsg_all(sock, [header, payload])


def _recv_exact(sock: socket.socket, n: int, *, at_boundary: bool
                ) -> bytearray | None:
    """Read exactly ``n`` bytes into a fresh *writable* buffer. Clean EOF *at
    a frame boundary* returns ``None`` (peer closed between frames); EOF
    anywhere else is a torn frame. The buffer is writable so that arrays
    decoded zero-copy over it stay mutable downstream."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            if at_boundary and got == 0:
                return None
            raise FrameError(
                f"torn frame: connection closed after {got}/{n} bytes")
        got += r
    return buf


def recv_frame(sock: socket.socket) -> bytearray | None:
    """Read one frame's payload; ``None`` on clean EOF. Raises
    :class:`FrameError` on torn writes, bad magic, oversized lengths, or
    checksum mismatch."""
    raw = _recv_exact(sock, _HEADER.size, at_boundary=True)
    if raw is None:
        return None
    magic, length, crc = _HEADER.unpack(raw)
    if magic != MAGIC:
        raise FrameError(f"bad magic {magic!r} (not a broker frame)")
    if length > MAX_FRAME_BYTES:
        raise FrameError(f"frame length {length} exceeds {MAX_FRAME_BYTES}")
    payload = _recv_exact(sock, length, at_boundary=False)
    if zlib.crc32(payload) != crc:
        raise FrameError("checksum mismatch (corrupt frame)")
    return payload


# Payloads arrive from the network, and pickle.loads on untrusted bytes is
# arbitrary code execution — the op allow-list below would never get a say.
# Unpickling therefore resolves globals only from this closed set: container
# builtins, the numpy array-reconstruction machinery, and the broker's own
# record types. Anything else (os.system, subprocess, custom classes) is
# refused before instantiation. Extend deliberately via register_safe().
_SAFE_GLOBALS: set[tuple[str, str]] = (
    {("builtins", n) for n in (
        "list", "dict", "tuple", "set", "frozenset", "bytes", "bytearray",
        "str", "int", "float", "complex", "bool", "slice", "range",
    )}
    | {(mod, name)
       for mod in ("numpy.core.multiarray", "numpy._core.multiarray")
       for name in ("_reconstruct", "scalar")}
    | {(mod, "_frombuffer")
       for mod in ("numpy.core.numeric", "numpy._core.numeric")}
    | {("numpy", "ndarray"), ("numpy", "dtype")}
    | {("repro_torch.core.broker", "Record"),
       ("repro_torch.core.broker", "OffsetRange")}
)


def register_safe(module: str, name: str) -> None:
    """Allow one more global through the transport's restricted unpickler
    (for pipelines whose record values are custom classes). Register on both
    sides of the socket."""
    _SAFE_GLOBALS.add((module, name))


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str) -> Any:
        if (module, name) in _SAFE_GLOBALS:
            return super().find_class(module, name)
        raise FrameError(
            f"refusing to unpickle {module}.{name} from the wire "
            "(not in the transport allow-list; see register_safe)")


def _restricted_load(data, buffers=None) -> Any:
    return _RestrictedUnpickler(io.BytesIO(data), buffers=buffers).load()


# -- message layer: kind byte + optional raw array region --------------------

def _nbytes(part) -> int:
    return part.nbytes if isinstance(part, memoryview) else len(part)


def encode_message(obj: Any) -> list:
    """Encode one message into frame-payload *parts* (bytes/memoryviews whose
    concatenation is the payload). With :data:`USE_ARRAY_FRAMES`, contiguous
    ndarrays anywhere in ``obj`` are emitted as raw out-of-band buffers — the
    returned memoryviews alias the arrays, nothing is copied."""
    if not USE_ARRAY_FRAMES:
        return [KIND_PICKLE
                + pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)]
    bufs: list[memoryview] = []

    def keep_out_of_band(pb: pickle.PickleBuffer):
        try:
            m = pb.raw()               # flat byte view; raises if
        except BufferError:            # non-contiguous -> stay in-band
            return True
        bufs.append(m)
        return False

    skeleton = pickle.dumps(obj, protocol=5, buffer_callback=keep_out_of_band)
    if not bufs:
        return [KIND_PICKLE + skeleton]
    head = KIND_ARRAY + _ARRAY_HEADER.pack(len(skeleton), len(bufs)) \
        + struct.pack(f">{len(bufs)}Q", *(m.nbytes for m in bufs))
    return [head, skeleton, *bufs]


def decode_message(payload) -> Any:
    """Decode one frame payload (either message kind). Raises
    :class:`FrameError` for anything malformed — unknown kind, region lengths
    that do not add up, undecodable pickle — never returns garbage. Arrays in
    ``A`` messages are reconstructed as zero-copy views over ``payload``
    (pass a writable buffer, e.g. from :func:`recv_frame`, to keep them
    mutable). The flip side of zero copy: every such array keeps the *whole*
    frame buffer alive — consumers that cherry-pick one array out of a large
    multi-record frame and retain it long-term should ``np.copy()`` it."""
    view = memoryview(payload)
    if view.nbytes == 0:
        raise FrameError("empty message payload")
    kind, body = bytes(view[:1]), view[1:]
    try:
        if kind == KIND_PICKLE:
            return _restricted_load(body)
        if kind == KIND_ARRAY:
            if body.nbytes < _ARRAY_HEADER.size:
                raise FrameError("array message too short for its header")
            skeleton_len, nbufs = _ARRAY_HEADER.unpack_from(body, 0)
            lens_end = _ARRAY_HEADER.size + 8 * nbufs
            if lens_end > body.nbytes:
                raise FrameError("array message too short for buffer lengths")
            lens = struct.unpack_from(f">{nbufs}Q", body, _ARRAY_HEADER.size)
            if lens_end + skeleton_len + sum(lens) != body.nbytes:
                raise FrameError("array message region lengths do not add up")
            skeleton = body[lens_end:lens_end + skeleton_len]
            bufs, pos = [], lens_end + skeleton_len
            for n in lens:
                bufs.append(body[pos:pos + n])
                pos += n
            return _restricted_load(skeleton, bufs)
        raise FrameError(f"unknown message kind {kind!r}")
    except FrameError:
        raise
    except Exception as e:             # torn pickle, struct error, ...
        raise FrameError(f"undecodable {kind!r} message: {e}") from e


# -- shared-memory frames ('S'): same-host zero-copy bulk path ---------------

_host_token_cache: str | None = None


def _host_token() -> str:
    """This machine's identity for the same-host shm negotiation: hostname
    plus the kernel boot id, so two hosts sharing a hostname never falsely
    negotiate shared memory. (Containers sharing a kernel but not /dev/shm
    normally differ in hostname; :data:`USE_SHM_FRAMES` covers the rest.)"""
    global _host_token_cache
    if _host_token_cache is None:
        try:
            with open("/proc/sys/kernel/random/boot_id") as f:
                boot = f.read().strip()
        except OSError:                # pragma: no cover - non-Linux
            boot = "-"
        _host_token_cache = f"{socket.gethostname()}:{boot}"
    return _host_token_cache


def build_shm_payload(skeleton, bufs, name: str, seg: memoryview) -> bytes:
    """Copy out-of-band buffers into the shared-memory view ``seg`` (packed
    back to back from offset 0) and return the small ``S`` frame payload
    describing them. The caller leased ``seg`` via the ``shm_alloc`` op, so
    it is at least ``sum(nbytes)`` long."""
    name_b = name.encode("ascii")
    descs, pos = [], 0
    for b in bufs:
        m = (b if isinstance(b, memoryview) else memoryview(b)).cast("B")
        n = m.nbytes
        seg[pos:pos + n] = m
        descs.append(_SHM_DESC.pack(pos, n))
        pos += n
    return b"".join((KIND_SHM,
                     _SHM_HEADER.pack(len(skeleton), len(bufs), len(name_b)),
                     name_b, *descs, skeleton))


def decode_shm_payload(payload, resolve) -> tuple[Any, str]:
    """Decode one ``S`` frame payload. ``resolve(name)`` maps a segment name
    to its memoryview (``None`` for a segment this connection does not own —
    refused, like every other malformed descriptor, with
    :class:`FrameError`). Returns ``(message, segment_name)``; arrays are
    zero-copy views over the shared segment, so the segment must stay mapped
    for as long as they live (:class:`_ShmPool` ref-counts exactly that)."""
    view = memoryview(payload)
    body = view[1:]
    try:
        if body.nbytes < _SHM_HEADER.size:
            raise FrameError("shm message too short for its header")
        skeleton_len, nbufs, name_len = _SHM_HEADER.unpack_from(body, 0)
        pos = _SHM_HEADER.size
        descs_end = pos + name_len + _SHM_DESC.size * nbufs
        if descs_end + skeleton_len != body.nbytes:
            raise FrameError("shm message region lengths do not add up")
        name = bytes(body[pos:pos + name_len]).decode("ascii", "replace")
        pos += name_len
        seg = resolve(name)
        if seg is None:
            raise FrameError(f"shm message names unknown segment {name!r}")
        bufs = []
        for _ in range(nbufs):
            off, length = _SHM_DESC.unpack_from(body, pos)
            pos += _SHM_DESC.size
            if off + length > seg.nbytes:
                raise FrameError(
                    f"shm descriptor [{off}, {off + length}) outside its "
                    f"{seg.nbytes}-byte segment")
            bufs.append(seg[off:off + length])
        return _restricted_load(body[descs_end:], bufs), name
    except FrameError:
        raise
    except Exception as e:             # torn pickle, struct error, ...
        raise FrameError(f"undecodable {KIND_SHM!r} message: {e}") from e


_shm_seq = itertools.count()


class _ShmSegment:
    """One server-owned shared-memory segment plus its bookkeeping: a lease
    flag (handed to the client, no ``S`` frame seen yet), a refcount of live
    arrays decoded out of it, and the mapped address range the refcounter
    matches arrays against."""

    __slots__ = ("shm", "size", "addr", "refs", "leased", "unlinked")

    def __init__(self, size: int) -> None:
        name = f"{_SHM_PREFIX}_{os.getpid()}_{next(_shm_seq)}"
        self.shm = shared_memory.SharedMemory(name=name, create=True,
                                              size=size)
        self.size = self.shm.size
        probe = np.frombuffer(self.shm.buf, dtype=np.uint8)
        self.addr = probe.__array_interface__["data"][0]
        del probe                      # drop the buffer export before close
        self.refs = 0
        self.leased = False
        self.unlinked = False

    @property
    def name(self) -> str:
        return self.shm.name


def _abandon_shm(shm: shared_memory.SharedMemory) -> None:
    """A view over the mapping is still exported (e.g. interpreter shutdown
    runs ``weakref.finalize`` callbacks while the arrays are technically
    alive), so ``close()`` raises BufferError — and letting
    ``SharedMemory.__del__`` retry would spray "Exception ignored" noise.
    Abandon the mapping instead: drop our references, close the fd, and let
    the mmap die with its last view. The name is already unlinked, so the
    memory is reclaimed with the process either way."""
    shm._buf = None
    shm._mmap = None
    if shm._fd >= 0:                   # pragma: no branch
        os.close(shm._fd)
        shm._fd = -1


def _close_shm(shm: shared_memory.SharedMemory) -> None:
    try:
        shm.close()
    except BufferError:
        _abandon_shm(shm)


_tracker_patch_lock = threading.Lock()


def _attach_untracked(name: str) -> shared_memory.SharedMemory:
    """Attach a server-owned segment without registering it with this
    process's resource_tracker. Python 3.10 registers *attached* segments
    too (3.13 grew ``track=False``); if this process shares its tracker
    with the server — a ``multiprocessing`` child does — any register or
    unregister we issue unbalances the server's own create/unlink pair and
    the shared tracker dies with a KeyError traceback at unlink time. So
    suppress the registration at the source: swallow register calls for
    exactly this name while attaching (the name is unique to one lease, so
    nothing else can race into the filter)."""
    with _tracker_patch_lock:
        orig = resource_tracker.register

        def _skip(rname: str, rtype: str) -> None:
            if rtype == "shared_memory" and rname.lstrip("/") == name:
                return
            orig(rname, rtype)

        resource_tracker.register = _skip
        try:
            return shared_memory.SharedMemory(name=name)
        finally:
            resource_tracker.register = orig


def _close_segment(seg: _ShmSegment) -> None:
    _close_shm(seg.shm)


def _walk_arrays(obj, out: list) -> list:
    if isinstance(obj, np.ndarray):
        out.append(obj)
    elif isinstance(obj, (list, tuple, set, frozenset)):
        for x in obj:
            _walk_arrays(x, out)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _walk_arrays(k, out)
            _walk_arrays(v, out)
    return out


class _ShmPool:
    """Per-connection pool of server-owned shared-memory segments.

    A client leases a segment (``shm_alloc``), copies its array buffers in
    and sends an ``S`` frame naming it; the arrays decoded out of the frame
    are zero-copy views over the mapping, so the pool pins the segment with
    one refcount per such array (``weakref.finalize``) and only recycles it
    for a later lease once every view died. Ownership is strictly server
    side: when the connection drops — including a SIGKILLed producer — every
    segment is unlinked immediately (``release_all``), closing the mappings
    as their last views die, so nothing is ever stranded in ``/dev/shm``.
    """

    def __init__(self, max_bytes: int | None = None) -> None:
        self.max_bytes = (SHM_POOL_MAX_BYTES if max_bytes is None
                          else max_bytes)
        self._segments: dict[str, _ShmSegment] = {}
        self._lock = new_lock("_ShmPool._lock")

    def alloc(self, size) -> str | None:
        """Lease a segment of at least ``size`` bytes; ``None`` declines
        (over the pool cap, or shm unavailable) and the client falls back
        to an ``A`` frame."""
        size = int(size)
        if size <= 0 or size > self.max_bytes:
            return None
        with self._lock:
            free = [s for s in self._segments.values()
                    if not s.leased and not s.unlinked and s.refs == 0
                    and s.size >= size]
            if free:
                seg = min(free, key=lambda s: s.size)
            else:
                total = sum(s.size for s in self._segments.values())
                want = max(_SHM_SEGMENT_MIN, 1 << (size - 1).bit_length())
                if total + want > self.max_bytes:
                    return None
                try:
                    seg = _ShmSegment(want)
                except OSError:        # /dev/shm full or unavailable
                    return None
                self._segments[seg.name] = seg
            seg.leased = True
            return seg.name

    def resolve(self, name: str) -> memoryview | None:
        with self._lock:
            seg = self._segments.get(name)
            if seg is None or seg.unlinked:
                return None
            return memoryview(seg.shm.buf)

    def track(self, name: str, obj: Any) -> None:
        """End the lease opened by :meth:`alloc` and pin the segment for as
        long as any ndarray decoded out of it stays alive."""
        with self._lock:
            seg = self._segments.get(name)
            if seg is None:
                return
            seg.leased = False
            for arr in _walk_arrays(obj, []):
                addr = arr.__array_interface__["data"][0]
                if seg.addr <= addr < seg.addr + seg.size:
                    seg.refs += 1
                    weakref.finalize(arr, self._decref, name)

    def _decref(self, name: str) -> None:
        with self._lock:
            seg = self._segments.get(name)
            if seg is None:
                return
            seg.refs -= 1
            if seg.refs == 0 and seg.unlinked:
                self._segments.pop(name, None)
                _close_segment(seg)

    def segment_count(self) -> int:
        with self._lock:
            return len(self._segments)

    def release_all(self) -> None:
        """Connection dropped: unlink every segment *now* (nothing remains
        in ``/dev/shm``), close each mapping once its last view dies."""
        with self._lock:
            for seg in list(self._segments.values()):
                if not seg.unlinked:
                    seg.unlinked = True
                    try:
                        seg.shm.unlink()
                    except OSError:    # pragma: no cover - already gone
                        pass
                if seg.refs == 0:
                    self._segments.pop(seg.name, None)
                    _close_segment(seg)


def _message_checksum(parts) -> tuple[int, int]:
    total, crc = 0, 0
    for p in parts:
        total += _nbytes(p)
        crc = zlib.crc32(p, crc)
    return total, crc


def _send_parts(sock: socket.socket, parts, total: int, crc: int) -> None:
    """One frame from pre-encoded parts. The header and the two small lead
    parts coalesce into one buffer; everything else — the payload of a
    single-part frame, every array buffer — goes straight from its own
    memory via scatter-gather ``sendmsg``, no O(frame) concat anywhere."""
    header = _HEADER.pack(MAGIC, total, crc)
    if len(parts) == 1:
        _sendmsg_all(sock, [header, parts[0]])
        return
    _sendmsg_all(sock, [header + parts[0] + parts[1], *parts[2:]])


def send_message(sock: socket.socket, obj: Any) -> int:
    """Encode ``obj`` (array-aware) and send it as one frame. Returns the
    frame's payload size in bytes (what the byte counters account)."""
    parts = encode_message(obj)
    total, crc = _message_checksum(parts)
    if total > MAX_FRAME_BYTES:
        raise FrameError(f"message of {total} bytes exceeds the "
                         f"{MAX_FRAME_BYTES}-byte frame limit")
    _send_parts(sock, parts, total, crc)
    return total


def recv_message(sock: socket.socket) -> Any:
    """Receive and decode one message; ``None`` on clean EOF (broker
    messages are always tuples, so ``None`` is unambiguous)."""
    payload = recv_frame(sock)
    if payload is None:
        return None
    return decode_message(payload)


def _make_socket(address: Any) -> socket.socket:
    family = socket.AF_UNIX if isinstance(address, str) else socket.AF_INET
    return socket.socket(family, socket.SOCK_STREAM)


# -- server ------------------------------------------------------------------

# The server executes exactly these broker methods; anything else is an error
# frame, never an attribute lookup on the broker (no remote getattr).
# "ping", "stats", "hello" and "shm_alloc" are served by the transport
# itself, not the broker.
_OPS = frozenset({
    "create_topic", "topics", "num_partitions", "produce", "produce_many",
    "read", "end_offset", "end_offsets", "commit", "committed",
    "commit_groups", "lag", "ping", "stats", "hello", "shm_alloc",
    "topic_codec",
    # consumer-group protocol (repro_torch.data.groups), hosted by the broker
    "join_group", "heartbeat", "sync_group", "leave_group", "describe_group",
    # replication/HA protocol (repro_torch.data.replication): followers pull
    # raw record frames and report high-watermarks; clients fence/promote
    "fetch_frames", "replica_sync", "replica_hwm", "broker_epoch",
    "promote", "fence",
})


class BrokerServer:
    """Serve a local :class:`Broker` to remote clients over a socket.

    ``address`` is ``(host, port)`` for TCP (port 0 picks an ephemeral port;
    read the bound one back from ``.address``) or a filesystem path for a
    Unix domain socket. One thread accepts, one thread per connection
    handles request/response frames — a client's requests execute in order,
    which is what keeps per-partition ordering identical to in-process use.

    Requests are ``(op, args, kwargs)``; responses ``("ok", value)`` or
    ``("err", exc_type_name, message)``. Malformed frames are counted in
    ``frames_rejected`` and drop the offending connection only.
    """

    def __init__(self, broker: Broker, address: Any = ("127.0.0.1", 0),
                 accept_poll: float = 0.1) -> None:
        self.broker = broker
        self._requested = address
        self._accept_poll = accept_poll
        self._listener: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._conns: list[socket.socket] = []
        self._lock = new_lock("BrokerServer._lock")
        self._stop = threading.Event()
        self.address: Any = None       # bound address, set by start()
        self.requests_served = 0
        self.frames_rejected = 0
        self.shm_frames = 0            # 'S' frames decoded (all connections)
        self._shm_pools: list[_ShmPool] = []
        reg = get_registry()
        self._m_requests = reg.counter(
            "transport_requests_total",
            "broker requests served over the socket transport")
        self._m_rejected = reg.counter(
            "transport_frames_rejected_total",
            "malformed/torn frames rejected (connection dropped)")
        self._m_bytes_in = reg.counter(
            "transport_bytes_received_total",
            "request frame payload bytes received")
        self._m_bytes_out = reg.counter(
            "transport_bytes_sent_total",
            "response frame payload bytes sent")
        self._m_shm_frames = reg.counter(
            "transport_shm_frames_total",
            "'S' frames decoded over server-owned shared-memory segments")
        reg.gauge("transport_connections", "live client connections",
                  callback=lambda: len(self._conns))
        reg.gauge("transport_shm_segments",
                  "pooled shared-memory segments across live connections",
                  callback=lambda: sum(p.segment_count()
                                       for p in list(self._shm_pools)))

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "BrokerServer":
        listener = _make_socket(self._requested)
        if not isinstance(self._requested, str):
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(self._requested)
        listener.listen(32)
        listener.settimeout(self._accept_poll)
        self._listener = listener
        self.address = (self._requested if isinstance(self._requested, str)
                        else listener.getsockname())
        self._stop.clear()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="broker-server")
        self._accept_thread.start()
        log.info("broker server listening on %s", self.address)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=10)
            self._accept_thread = None
        if self._listener is not None:
            self._listener.close()
            self._listener = None
        with self._lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()

    def __enter__(self) -> "BrokerServer":
        return self.start() if self._listener is None else self

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- loops -------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return                     # listener closed under us
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="broker-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        # Per-connection shm state: ``enabled`` is flipped by a successful
        # hello negotiation; the pool owns every segment this client leases.
        state = {"shm": False, "pool": _ShmPool()}
        with self._lock:
            self._shm_pools.append(state["pool"])
        try:
            while not self._stop.is_set():
                try:
                    payload = recv_frame(conn)
                except FrameError as e:
                    # Torn/corrupt input: reject the frame AND the stream —
                    # after a bad header there is no resync point.
                    with self._lock:
                        self.frames_rejected += 1
                    self._m_rejected.inc()
                    log.warning("rejecting connection: %s", e)
                    return
                if payload is None:
                    return                 # client closed cleanly
                self._m_bytes_in.inc(len(payload))
                try:
                    sent = send_message(conn, self._dispatch(payload, state))
                except FrameError:
                    # response too large for one frame: tell the client
                    # instead of dying silently (e.g. a read() of a huge
                    # offset range; the client should narrow it)
                    sent = send_message(conn, (
                        "err", "FrameError",
                        f"response exceeds the {MAX_FRAME_BYTES}-byte "
                        f"frame limit; narrow the request"))
                self._m_bytes_out.inc(sent)
        except OSError:
            pass                           # peer vanished mid-response
        finally:
            # drop the pool from the live set first, under the lock, so
            # stats() never counts a pool whose segments are already gone;
            # then unlink the connection's shm segments before the socket
            # closes: the no-stranded-/dev/shm guarantee for SIGKILLed and
            # vanished producers alike
            with self._lock:
                if state["pool"] in self._shm_pools:
                    self._shm_pools.remove(state["pool"])
            state["pool"].release_all()
            conn.close()
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _decode_request(self, payload, state) -> Any:
        if bytes(memoryview(payload)[:1]) == KIND_SHM:
            if not state["shm"]:
                raise FrameError(
                    "shm frame on a connection that did not negotiate it")
            msg, name = decode_shm_payload(payload, state["pool"].resolve)
            # the lease ends here; the segment stays pinned while any array
            # decoded out of it is alive
            state["pool"].track(name, msg)
            with self._lock:
                self.shm_frames += 1
            self._m_shm_frames.inc()
            return msg
        return decode_message(payload)

    def _hello(self, state, caps: dict) -> dict:
        """Capability negotiation: shm frames are offered only when both
        sides want them *and* the client proved it shares this host (same
        hostname + kernel boot id, so /dev/shm is the same filesystem)."""
        same_host = caps.get("host") == _host_token()
        state["shm"] = bool(USE_SHM_FRAMES and same_host
                            and caps.get("shm"))
        return {"shm": state["shm"], "host": _host_token(),
                "shm_max_bytes": state["pool"].max_bytes}

    def _dispatch(self, payload, state) -> tuple:
        try:
            op, args, kwargs = self._decode_request(payload, state)
            if op not in _OPS:
                raise ValueError(f"unknown op {op!r}")
            with self._lock:
                self.requests_served += 1
            self._m_requests.inc()
            if op == "ping":
                return ("ok", "pong")
            if op == "stats":
                return ("ok", self.stats())
            if op == "hello":
                return ("ok", self._hello(state, *args, **kwargs))
            if op == "shm_alloc":
                if not state["shm"]:
                    return ("ok", None)    # decline: client uses 'A' frames
                return ("ok", state["pool"].alloc(*args, **kwargs))
            return ("ok", getattr(self.broker, op)(*args, **kwargs))
        except Exception as e:             # broker errors travel as frames
            return ("err", type(e).__name__, str(e))

    def stats(self) -> dict:
        """The server's own transport counters — served over the wire as the
        ``stats`` op, so remote producers can see ``requests_served`` /
        ``frames_rejected`` instead of only local attribute reads."""
        with self._lock:
            return {"requests_served": self.requests_served,
                    "frames_rejected": self.frames_rejected,
                    "connections": len(self._conns),
                    "shm_frames": self.shm_frames,
                    "shm_segments": sum(p.segment_count()
                                        for p in self._shm_pools)}


def serve_broker(broker: Broker, address: Any = ("127.0.0.1", 0)
                 ) -> BrokerServer:
    """Start a :class:`BrokerServer`; returns it with ``.address`` bound."""
    return BrokerServer(broker, address).start()


# -- client ------------------------------------------------------------------

_ERR_TYPES: dict[str, Callable[[str], Exception]] = {
    "KeyError": KeyError, "ValueError": ValueError, "TypeError": TypeError,
    # HA fencing errors must survive the wire typed: FailoverBroker reacts
    # to them (fail over, re-point), unlike a generic TransportError
    "BrokerFencedError": BrokerFencedError,
    "NotPrimaryError": NotPrimaryError,
}


class RemoteBroker:
    """Client-side :class:`Broker` duck type backed by a :class:`BrokerServer`.

    Every broker call is one request/response frame exchange under a lock
    (callers on many threads serialize, preserving per-client order). On a
    connection failure — server restart, torn frame, refused connect — the
    client closes, waits ``retry_delay * 2**attempt`` and reconnects, up to
    ``max_retries`` times, then raises :class:`TransportError`. A retried
    ``produce``/``produce_many`` whose ack was lost may duplicate the record
    (or the whole batch): delivery is at-least-once, and exactly-once is
    restored by idempotent sinks (the reference's ``docs/transport.md``).

    ``shm`` controls the same-host shared-memory fast path: ``None`` follows
    the module :data:`USE_SHM_FRAMES` kill switch, ``False`` opts this client
    out (benchmarks price the two paths against each other this way). When
    negotiated, array-bearing requests lease a server-owned segment per
    request, copy the buffers in, and send a small ``S`` descriptor frame
    instead of the bulk bytes; anything that fails along the way falls back
    to a plain ``A`` frame.
    """

    def __init__(self, address: Any, connect_timeout: float = 5.0,
                 max_retries: int = 5, retry_delay: float = 0.05,
                 shm: bool | None = None) -> None:
        self.address = address
        self.connect_timeout = connect_timeout
        self.max_retries = max_retries
        self.retry_delay = retry_delay
        self._shm_want = shm
        self._shm_ok = False
        self._attached: dict[str, shared_memory.SharedMemory] = {}
        self.shm_frames_sent = 0
        self._sock: socket.socket | None = None
        self._lock = new_rlock("RemoteBroker._lock")
        self.reconnects = 0
        self._m_reconnects = get_registry().counter(
            "transport_reconnects_total",
            help="client reconnects after a dropped broker connection")

    # -- connection --------------------------------------------------------
    def _connect(self) -> None:
        sock = _make_socket(self.address)
        sock.settimeout(self.connect_timeout)
        try:
            sock.connect(self.address)
        except BaseException:
            sock.close()
            raise
        sock.settimeout(None)
        if isinstance(self.address, tuple):
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._shm_ok = False
        want = USE_SHM_FRAMES if self._shm_want is None else self._shm_want
        if want:
            resp = self._roundtrip(
                ("hello", ({"host": _host_token(), "shm": True},), {}))
            if resp[0] == "ok":        # an "err" (old server) just means no shm
                self._shm_ok = bool(resp[1].get("shm"))

    def _roundtrip(self, msg) -> tuple:
        """One raw request/response exchange on the live socket — used
        inside :meth:`_connect`/:meth:`_request` where the usual retry
        machinery is already wrapped around the caller."""
        send_message(self._sock, msg)
        payload = recv_frame(self._sock)
        if payload is None:
            raise FrameError("server closed the connection")
        return decode_message(payload)

    def _detach_segments(self) -> None:
        for shm in self._attached.values():
            _close_shm(shm)
        self._attached.clear()

    def _attach_segment(self, name: str) -> shared_memory.SharedMemory:
        shm = self._attached.get(name)
        if shm is None:
            shm = _attach_untracked(name)
            self._attached[name] = shm
        return shm

    def _send_shm(self, parts) -> bool:
        """Try to send the encoded request as an ``S`` frame: lease a
        server-owned segment, copy the out-of-band buffers in, send the
        descriptor frame. ``False`` means the server declined the lease —
        the caller falls back to a plain ``A`` frame. Socket-level failures
        raise and land in the caller's retry loop."""
        bufs = parts[2:]
        need = sum(_nbytes(b) for b in bufs)
        if need == 0:
            return False
        resp = self._roundtrip(("shm_alloc", (need,), {}))
        if resp[0] != "ok" or not resp[1]:
            return False
        shm = self._attach_segment(resp[1])
        payload = build_shm_payload(parts[1], bufs, resp[1],
                                    memoryview(shm.buf))
        send_frame(self._sock, payload)
        self.shm_frames_sent += 1
        return True

    def _close(self) -> None:
        self._detach_segments()
        self._shm_ok = False
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._close()

    def __enter__(self) -> "RemoteBroker":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- request/response --------------------------------------------------
    def _request(self, op: str, *args: Any, **kwargs: Any) -> Any:
        parts = encode_message((op, args, kwargs))
        total = sum(_nbytes(p) for p in parts)
        if total > MAX_FRAME_BYTES:
            # permanent protocol violation, not a connectivity problem:
            # no number of retries makes an oversized frame fit
            raise FrameError(
                f"{op} request of {total} bytes exceeds the "
                f"{MAX_FRAME_BYTES}-byte frame limit")
        # the frame CRC is an O(payload) pass over the bulk buffers — computed
        # lazily, only if the bytes actually go through the socket (the shm
        # path never frames them, and its small descriptor frame has its own)
        crc: int | None = None
        last: Exception | None = None
        with self._lock:
            for attempt in range(self.max_retries + 1):
                try:
                    if self._sock is None:
                        self._connect()
                        if attempt:
                            self.reconnects += 1
                            self._m_reconnects.inc()
                    # len(parts) >= 3 ⇔ the request carries out-of-band
                    # array buffers — the only frames worth a shm round trip
                    if not (self._shm_ok and len(parts) >= 3
                            and self._send_shm(parts)):
                        if crc is None:
                            crc = _message_checksum(parts)[1]
                        _send_parts(self._sock, parts, total, crc)
                    payload = recv_frame(self._sock)
                    if payload is None:
                        raise FrameError("server closed the connection")
                    resp = decode_message(payload)
                except (OSError, FrameError) as e:
                    last = e
                    self._close()
                    if attempt < self.max_retries:
                        time.sleep(self.retry_delay * (2 ** attempt))
                    continue
                if resp[0] == "ok":
                    return resp[1]
                _, exc_name, message = resp
                raise _ERR_TYPES.get(exc_name, TransportError)(message)
        raise TransportError(
            f"broker at {self.address!r} unreachable after "
            f"{self.max_retries + 1} attempts: {last}") from last

    # -- Broker surface ----------------------------------------------------
    def ping(self) -> bool:
        return self._request("ping") == "pong"

    def stats(self) -> dict:
        """Server-side transport counters (``requests_served``,
        ``frames_rejected``, ``connections``) fetched over the wire."""
        return self._request("stats")

    def create_topic(self, topic: str, partitions: int = 1,
                     codec: str | None = None) -> None:
        if codec is None:              # wire-compatible with older servers
            self._request("create_topic", topic, partitions)
        else:
            self._request("create_topic", topic, partitions, codec=codec)

    def topic_codec(self, topic: str) -> str | None:
        return self._request("topic_codec", topic)

    def topics(self) -> list[str]:
        return self._request("topics")

    def num_partitions(self, topic: str) -> int:
        return self._request("num_partitions", topic)

    def produce(self, topic: str, value: Any, key: bytes | None = None,
                partition: int | None = None, timestamp: float = 0.0) -> int:
        """Append one record; returns its partition-local offset.

        One request/response round trip per record — the per-record cost
        `bench_ingest` prices as ``ingest/remote_transport``. Hot paths
        should batch with :meth:`produce_many` instead (one frame per batch).
        Delivery is at-least-once: a retry whose ack was lost appends the
        record twice; idempotent-by-key sinks dedupe downstream.
        """
        return self._request("produce", topic, value, key=key,
                             partition=partition, timestamp=timestamp)

    def produce_many(self, topic: str, pairs, partition: int | None = None,
                     timestamp: float = 0.0) -> list[int]:
        """Append a batch of ``(key, value)`` pairs in one round trip;
        returns their offsets in input order.

        This is the transport fast path: the whole batch crosses the socket
        as one frame (an array frame when values hold ndarrays — detector
        frames skip pickle entirely), amortizing framing and latency across
        the batch. Semantics:

        - **Validation is all-or-nothing**: an unknown topic, bad partition
          or malformed pair fails the whole batch server-side with nothing
          appended.
        - **Delivery is at-least-once per batch**: if the ack is lost and the
          request retried, the *entire batch* may append twice. The sinks'
          idempotency-by-key still restores exactly-once downstream, exactly
          as for single ``produce`` retries.
        - Per-partition order within the batch follows pair order.
        """
        return self._request("produce_many", topic, list(pairs),
                             partition=partition, timestamp=timestamp)

    def read(self, rng: OffsetRange) -> list[Record]:
        return self._request("read", rng)

    def end_offset(self, topic: str, partition: int = 0) -> int:
        return self._request("end_offset", topic, partition)

    def end_offsets(self, topic: str) -> list[int]:
        return self._request("end_offsets", topic)

    def commit(self, topic: str, partition: int, offset: int,
               group: str = "", consumer: str | None = None,
               generation: int | None = None) -> None:
        self._request("commit", topic, partition, offset, group=group,
                      consumer=consumer, generation=generation)

    def committed(self, topic: str, group: str = "") -> list[int]:
        return self._request("committed", topic, group=group)

    def commit_groups(self, topic: str) -> list[str]:
        return self._request("commit_groups", topic)

    def lag(self, topic: str, group: str = "") -> int:
        return self._request("lag", topic, group=group)

    # -- consumer groups (repro_torch.data.groups; errors arrive as
    # GroupError / StaleGenerationError, which groups.py registers in
    # _ERR_TYPES) ----------------------------------------------------------
    def join_group(self, group: str, consumer: str, topics,
                   session_timeout: float = 5.0) -> dict:
        return self._request("join_group", group, consumer, list(topics),
                             session_timeout=session_timeout)

    def heartbeat(self, group: str, consumer: str, generation: int) -> dict:
        return self._request("heartbeat", group, consumer, generation)

    def sync_group(self, group: str, consumer: str, generation: int) -> dict:
        return self._request("sync_group", group, consumer, generation)

    def leave_group(self, group: str, consumer: str) -> None:
        self._request("leave_group", group, consumer)

    def describe_group(self, group: str) -> dict:
        return self._request("describe_group", group)

    # -- replication / HA (repro_torch.data.replication) ---------------------
    def fetch_frames(self, topic: str, partition: int, start: int,
                     max_bytes: int = 4 * 1024 * 1024) -> tuple:
        """Pull committed raw record frames for replication: returns
        ``(blob, lengths, next_offset, end_offset)`` — one contiguous blob
        of the durable log's CRC-framed bytes, shipped verbatim, plus each
        frame's size within it."""
        return self._request("fetch_frames", topic, partition, start,
                             max_bytes=max_bytes)

    def replica_sync(self, replica_id: str, cursors: dict,
                     max_bytes: int = 4 * 1024 * 1024) -> dict:
        """One replication round in one round trip: report ``cursors`` as
        this replica's high-watermarks and pull every partition's tail past
        them (:meth:`repro_torch.core.broker.Broker.replica_sync`)."""
        return self._request("replica_sync", replica_id, cursors,
                             max_bytes=max_bytes)

    def replica_hwm(self, replica_id: str | None = None,
                    hwms: dict | None = None) -> dict:
        """Report this replica's per-partition replicated high-watermarks
        (when ``replica_id`` and ``hwms`` are given) and fetch the whole
        map."""
        return self._request("replica_hwm", replica_id=replica_id, hwms=hwms)

    def broker_epoch(self) -> dict:
        return self._request("broker_epoch")

    def promote(self, epoch: int) -> dict:
        return self._request("promote", epoch)

    def fence(self, epoch: int) -> dict:
        return self._request("fence", epoch)


def parse_address(spec: str) -> Any:
    """CLI helper: ``"host:port"`` → TCP tuple, anything else → Unix path."""
    host, sep, port = spec.rpartition(":")
    if sep and port.isdigit():
        return (host or "127.0.0.1", int(port))
    return spec
