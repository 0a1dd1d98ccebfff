"""The broker's message codec, the counterpart of the message layer of
``repro/data/transport.py``.

A message is one *payload* whose first byte is its kind:

- ``P`` — a restricted-pickle blob (containers, scalars, the broker's
  record types; see :func:`register_safe`).
- ``A`` — an *array frame*: the message skeleton is still restricted
  pickle, but every contiguous ndarray's bytes travel as raw out-of-band
  buffers after the skeleton (pickle protocol 5 buffer references: the
  skeleton holds only dtype/shape/contiguity). Arrays skip pickling on
  encode, and on decode they are views over the payload buffer.

The durable log (:mod:`repro_torch.data.durable_log`) and the window-state
store (:mod:`repro_torch.data.state`) write these payloads inside their CRC
frames, byte for byte as the reference writes them, so each package reads
the other's files. Reads go through the restricted unpickler, which
resolves only the globals on the allow-list: a log holds frame ids, keys
and numpy arrays, never a device tensor, which the list would refuse.

The sockets, shared-memory frames, ``BrokerServer`` and ``RemoteBroker`` of
the reference are left out until the port's transport (ROADMAP, Queue 1
item 3.5).
"""
from __future__ import annotations

import io
import pickle
import struct
from typing import Any

# reject absurd lengths before allocating; the durable log refuses records
# past it, since its recovery scan treats longer frames as corruption
MAX_FRAME_BYTES = 256 * 1024 * 1024

# Message kinds: first payload byte. P = restricted pickle; A = array frame
# (pickled skeleton + raw out-of-band ndarray buffers, layout below).
KIND_PICKLE = b"P"
KIND_ARRAY = b"A"
# Array frame body, after the kind byte:
#   u32 skeleton_len | u32 nbufs | nbufs x u64 buf_len | skeleton | buf0 ...
_ARRAY_HEADER = struct.Struct(">II")

# Flip to False to force every ndarray through the pickle path.
USE_ARRAY_FRAMES = True


class TransportError(RuntimeError):
    """Client gave up: retries exhausted or the server returned a non-broker
    error."""


class FrameError(TransportError):
    """The byte stream is not a well-formed message (unknown kind, region
    lengths that do not add up, undecodable or refused pickle)."""


# pickle.loads on bytes from outside is arbitrary code execution, so
# unpickling resolves globals only from this closed set: container builtins,
# the numpy array-reconstruction machinery, and the broker's own record
# types. Anything else (os.system, custom classes, torch tensors) is refused
# before instantiation. Extend deliberately via register_safe().
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
    """Allow one more global through the restricted unpickler (for
    pipelines whose record values are custom classes)."""
    _SAFE_GLOBALS.add((module, name))


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str) -> Any:
        if (module, name) in _SAFE_GLOBALS:
            return super().find_class(module, name)
        raise FrameError(
            f"refusing to unpickle {module}.{name} "
            "(not in the transport allow-list; see register_safe)")


def _restricted_load(data, buffers=None) -> Any:
    return _RestrictedUnpickler(io.BytesIO(data), buffers=buffers).load()


def encode_message(obj: Any) -> list:
    """Encode one message into payload *parts* (bytes/memoryviews whose
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
    """Decode one payload (either message kind). Raises :class:`FrameError`
    for anything malformed — unknown kind, region lengths that do not add
    up, undecodable pickle — never returns garbage. Arrays in ``A`` messages
    are zero-copy views over ``payload`` (pass a writable buffer to keep
    them mutable); each keeps the whole payload buffer alive."""
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
