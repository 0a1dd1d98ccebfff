"""The port's wire framing on the CPU: the counterpart of
tests/test_transport_frames.py, the property-based suite for the three
message kinds of ``repro_torch.data.transport``.

The contract under test is connection-drop-only: a frame either decodes to
*exactly* what was sent, or the receiving side raises ``FrameError`` (clean
EOF at a frame boundary is ``None``). Truncation at any byte, any single-bit
flip, or arbitrary garbage must never crash the process and must never
surface a different ("garbage") record. All three kinds are exercised: ``P``
(restricted pickle), ``A`` (array frames) and ``S`` (same-host
shared-memory frames: the skeleton and buffer *descriptors* on the wire, the
bulk bytes in a server-owned segment).

Every test runs with the port's lock tracing on and asserts afterwards that
the locks it took were acquired in no cyclic order.
"""
import socket
import struct
import threading
import zlib

import numpy as np
import pytest

from hypothesis import given, settings, strategies as st

from repro_torch.data import locktrace
from repro_torch.data.transport import (KIND_ARRAY, KIND_PICKLE, KIND_SHM,
                                        MAGIC, FrameError, _ShmPool,
                                        build_shm_payload, decode_message,
                                        decode_shm_payload, encode_message,
                                        recv_frame, recv_message, send_frame,
                                        send_message)

_HEADER = struct.Struct(">2sII")       # mirror of the wire header


@pytest.fixture(autouse=True)
def port_lock_order():
    """The port's counterpart of tests/conftest.py's harness: traced locks
    for the test, and no lock-order cycle at the end."""
    locktrace.enable()
    try:
        yield
    finally:
        report = locktrace.disable().report()
    assert not report.cycles, (
        "lock-order cycles detected (potential deadlock):\n"
        + report.describe())


# -- plumbing ----------------------------------------------------------------

def _pair():
    a, b = socket.socketpair()
    a.settimeout(10)
    b.settimeout(10)
    return a, b


def _eq(a, b) -> bool:
    """Structural equality that is array-aware (== on ndarrays is elementwise)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        if not (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)):
            return False
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        equal_nan = np.issubdtype(a.dtype, np.inexact)
        return np.array_equal(a, b, equal_nan=equal_nan)
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_eq(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict) and isinstance(b, dict):
        return (a.keys() == b.keys()
                and all(_eq(a[k], b[k]) for k in a))
    return type(a) is type(b) and a == b


def _roundtrip(obj):
    a, b = _pair()
    try:
        send_message(a, obj)
        return recv_message(b)
    finally:
        a.close()
        b.close()


def _frame_bytes(obj) -> bytes:
    """The exact byte string one message frame occupies on the wire."""
    parts = encode_message(obj)
    payload = b"".join(bytes(p) for p in parts)
    return _HEADER.pack(MAGIC, len(payload), zlib.crc32(payload)) + payload


def _outcome(wire_bytes: bytes, original) -> str:
    """Feed (possibly corrupt) bytes to a receiver; classify the result.
    Anything other than {the exact original, clean EOF, FrameError} fails."""
    a, b = _pair()
    a.sendall(wire_bytes)
    a.close()
    try:
        try:
            got = recv_message(b)
        except FrameError:
            return "rejected"
    finally:
        b.close()
    if got is None:
        return "eof"
    assert _eq(got, original), f"garbage surfaced: {got!r} != {original!r}"
    return "intact"


# -- round trips (deterministic matrix; hypothesis widens it below) ----------

_DTYPES = [np.bool_, np.uint8, np.int16, np.int32, np.int64,
           np.float16, np.float32, np.float64, np.complex64, np.complex128]
_SHAPES = [(), (0,), (1,), (7,), (3, 4), (2, 3, 4)]


def _make_array(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))            # () -> 1, any 0-dim -> 0
    raw = rng.integers(0, 100, size=n)
    return raw.astype(dtype).reshape(shape)


def test_torch_array_roundtrip_dtype_shape_matrix_smoke():
    """Deterministic replicas of the hypothesis property (runs everywhere)."""
    for dtype in _DTYPES:
        for shape in _SHAPES:
            arr = _make_array(dtype, shape)
            got = _roundtrip(arr)
            assert _eq(got, arr), (dtype, shape)
    # orders and views: F-contiguous stays F; non-contiguous falls back
    # in-band but still round-trips exactly
    c = _make_array(np.float32, (6, 5), seed=1)
    f = np.asfortranarray(c)
    strided = c[::2, 1::2]
    for arr in (f, strided):
        got = _roundtrip(arr)
        assert _eq(got, arr)
    assert _roundtrip(f).flags["F_CONTIGUOUS"]


def test_torch_decoded_arrays_are_writable():
    """Zero-copy decode must not hand out read-only views — consumers
    (solvers) mutate frames in place."""
    arr = _make_array(np.float32, (16, 16))
    got = _roundtrip(("k", arr))[1]
    assert got.flags.writeable
    got += 1.0                             # must not raise
    assert _eq(got, arr + 1.0)


def test_torch_mixed_payload_roundtrip_smoke():
    objs = [
        b"", b"x" * 70_000, "text", 0, -1, 2.5, None, True,
        {"i": 1, "nested": (1, [2, 3], {"b": b"bytes"})},
        ("produce_many", ("t", [(b"k0", _make_array(np.float32, (3, 4))),
                                (None, (7, _make_array(np.int64, (5,))))]),
         {"partition": 1, "timestamp": 2.0}),
    ]
    for obj in objs:
        assert _eq(_roundtrip(obj), obj)


def test_torch_kind_selection():
    only_pickle = encode_message({"i": 1, "b": b"raw"})
    assert len(only_pickle) == 1 and only_pickle[0][:1] == KIND_PICKLE
    with_array = encode_message((b"k", _make_array(np.float32, (4, 4))))
    assert len(with_array) > 1 and bytes(with_array[0][:1]) == KIND_ARRAY


def test_torch_raw_frame_layer_roundtrip_bytes():
    import os
    a, b = _pair()
    try:
        for payload in (b"", b"z", os.urandom(10_000)):
            send_frame(a, payload)
            assert recv_frame(b) == payload
    finally:
        a.close()
        b.close()


# -- corruption: truncation --------------------------------------------------

_TRUNC_MSG = (b"key-7", _make_array(np.int32, (4, 4)), "meta")


def _check_truncation(cut: int) -> None:
    frame = _frame_bytes(_TRUNC_MSG)
    outcome = _outcome(frame[:cut], _TRUNC_MSG)
    if cut == 0:
        assert outcome == "eof"
    elif cut < len(frame):
        assert outcome == "rejected", f"cut={cut} not rejected"
    else:
        assert outcome == "intact"


def test_torch_every_truncation_point_rejected_smoke():
    """Exhaustive: cut the frame at *every* byte boundary. Only the empty
    stream (clean EOF) and the full frame are not errors."""
    frame = _frame_bytes(_TRUNC_MSG)
    for cut in range(len(frame) + 1):
        _check_truncation(cut)


# -- corruption: bit flips ---------------------------------------------------

def _check_bit_flip(byte_idx: int, bit: int) -> None:
    frame = bytearray(_frame_bytes(_TRUNC_MSG))
    frame[byte_idx % len(frame)] ^= 1 << bit
    # CRC-32 detects every single-bit error; header-field flips hit the
    # magic/length/CRC checks first. Nothing may come out but a rejection.
    assert _outcome(bytes(frame), _TRUNC_MSG) == "rejected"


def test_torch_bit_flips_rejected_smoke():
    """Deterministic replicas of the hypothesis property (runs everywhere):
    flips across the header, the kind byte, the skeleton and the raw array
    region."""
    frame_len = len(_frame_bytes(_TRUNC_MSG))
    rng = np.random.default_rng(11)
    positions = list(range(12))                    # full header + kind byte
    positions += [int(i) for i in rng.integers(12, frame_len, 60)]
    for byte_idx in positions:
        for bit in (0, 3, 7):
            _check_bit_flip(byte_idx, bit)


# -- corruption: garbage payloads against decode_message ---------------------

def test_torch_garbage_payloads_raise_frame_error_smoke():
    rng = np.random.default_rng(7)
    blobs = [bytes(rng.integers(0, 256, n, dtype=np.uint8).tolist())
             for n in (1, 2, 9, 64, 400)]
    cases = [b""] + blobs
    cases += [KIND_PICKLE + b for b in blobs]      # well-framed, bad pickle
    cases += [KIND_ARRAY + b for b in blobs]       # bad region headers
    # region lengths that do not add up
    cases += [KIND_ARRAY + struct.pack(">II", 10, 2)
              + struct.pack(">2Q", 4, 1 << 50) + b"x" * 30]
    for payload in cases:
        with pytest.raises(FrameError):
            decode_message(payload)


# -- exact wire bytes: the scatter-gather send path --------------------------

def _wire_bytes(send_fn) -> bytes:
    """Everything ``send_fn(sock)`` puts on the wire, read concurrently so
    large frames cannot deadlock on the socketpair buffer."""
    a, b = _pair()
    chunks: list[bytes] = []

    def reader():
        while True:
            data = b.recv(1 << 16)
            if not data:
                return
            chunks.append(data)

    t = threading.Thread(target=reader)
    t.start()
    try:
        send_fn(a)
    finally:
        a.close()
    t.join(timeout=10)
    b.close()
    assert not t.is_alive()
    return b"".join(chunks)


def test_torch_send_frame_wire_bytes_exact():
    """``send_frame`` writes exactly header+payload — the sendmsg rewrite
    (no O(frame) header+payload concat) must be byte-identical on the wire."""
    import os
    for payload in (b"", b"k", os.urandom(300_000)):
        got = _wire_bytes(lambda s: send_frame(s, payload))
        assert got == _HEADER.pack(MAGIC, len(payload),
                                   zlib.crc32(payload)) + payload


def test_torch_send_message_wire_bytes_exact():
    """``send_message`` (single-part pickle and multi-part array frames
    alike) is byte-identical to the concatenated encoding."""
    objs = [
        "plain-string",
        {"k": 1, "nested": [b"bytes", None]},
        (b"k", _make_array(np.float32, (512, 512))),     # 1 MiB bulk buffer
        ("produce_many", ("t", [(b"a", _make_array(np.int64, (7,))),
                                (b"b", _make_array(np.float64, (3, 3)))]),
         {}),
    ]
    for obj in objs:
        assert _wire_bytes(lambda s: send_message(s, obj)) == _frame_bytes(obj)


# -- shared-memory 'S' frames ------------------------------------------------

def _shm_payload(obj, pool: _ShmPool) -> bytes:
    """Encode ``obj`` the way RemoteBroker._send_shm does: out-of-band
    buffers into a leased pool segment, small descriptor payload back."""
    parts = encode_message(obj)
    assert len(parts) >= 3, "need an array-bearing message for an S frame"
    bufs = parts[2:]
    need = sum(b.nbytes if isinstance(b, memoryview) else len(b)
               for b in bufs)
    name = pool.alloc(max(need, 1))
    assert name is not None
    return build_shm_payload(parts[1], bufs, name, pool.resolve(name))


@pytest.fixture
def shm_pool():
    pool = _ShmPool()
    yield pool
    pool.release_all()
    assert pool.segment_count() == 0 or all(
        s.unlinked for s in pool._segments.values())


def test_torch_shm_roundtrip_dtype_shape_matrix(shm_pool):
    """Every dtype × shape that round-trips as an 'A' frame round-trips as
    an 'S' frame, buffers resolved out of the shared segment."""
    for dtype in _DTYPES:
        for shape in _SHAPES:
            arr = _make_array(dtype, shape)
            payload = _shm_payload((b"k", arr), shm_pool)
            assert payload[:1] == KIND_SHM
            got, name = decode_shm_payload(payload, shm_pool.resolve)
            shm_pool.track(name, got)
            assert _eq(got, (b"k", arr)), (dtype, shape)


def test_torch_shm_multi_buffer_message(shm_pool):
    """Several arrays in one message pack back to back into one segment."""
    msg = ("produce_many", ("t", [(b"a", _make_array(np.float32, (8, 8))),
                                  (b"b", _make_array(np.int16, (100,))),
                                  (b"c", _make_array(np.float64, (3, 4)))]),
           {"partition": 0})
    payload = _shm_payload(msg, shm_pool)
    got, name = decode_shm_payload(payload, shm_pool.resolve)
    shm_pool.track(name, got)
    assert _eq(got, msg)
    assert shm_pool.segment_count() == 1


def test_torch_shm_decoded_arrays_are_writable(shm_pool):
    payload = _shm_payload((b"k", _make_array(np.float32, (16, 16))),
                           shm_pool)
    got, name = decode_shm_payload(payload, shm_pool.resolve)
    shm_pool.track(name, got)
    arr = got[1]
    assert arr.flags.writeable
    arr += 1.0                             # must not raise


_SHM_MSG = (b"key-7", _make_array(np.int32, (4, 4)), "meta")


def test_torch_shm_truncation_every_point_rejected(shm_pool):
    """Cut the descriptor payload at every byte: nothing but the full
    payload may decode (region lengths never add up on a truncation)."""
    payload = _shm_payload(_SHM_MSG, shm_pool)
    for cut in range(len(payload)):
        with pytest.raises(FrameError):
            decode_shm_payload(payload[:cut], shm_pool.resolve)
    got, name = decode_shm_payload(payload, shm_pool.resolve)
    shm_pool.track(name, got)
    assert _eq(got, _SHM_MSG)


def test_torch_shm_frame_bit_flips_rejected(shm_pool):
    """On the wire the frame CRC covers the whole 'S' payload — name and
    descriptors included — so any single-bit flip is rejected at the frame
    layer before a descriptor is ever dereferenced."""
    payload = _shm_payload(_SHM_MSG, shm_pool)
    frame = _HEADER.pack(MAGIC, len(payload), zlib.crc32(payload)) + payload
    rng = np.random.default_rng(13)
    positions = list(range(12))                    # full header + kind byte
    positions += [int(i) for i in rng.integers(12, len(frame), 40)]
    for byte_idx in positions:
        corrupt = bytearray(frame)
        corrupt[byte_idx] ^= 1 << int(rng.integers(0, 8))
        a, b = _pair()
        a.sendall(bytes(corrupt))
        a.close()
        try:
            with pytest.raises(FrameError):
                recv_frame(b)
        finally:
            b.close()


def test_torch_shm_descriptor_out_of_segment_rejected(shm_pool):
    """A structurally valid descriptor pointing outside the named segment
    is refused — a client can never make the server read foreign memory."""
    payload = bytearray(_shm_payload(_SHM_MSG, shm_pool))
    (name_len,) = struct.unpack_from(">H", payload, 9)
    desc_at = 1 + 10 + name_len            # kind + _SHM_HEADER + name
    struct.pack_into(">QQ", payload, desc_at, 1 << 40, 16)
    with pytest.raises(FrameError, match="outside"):
        decode_shm_payload(bytes(payload), shm_pool.resolve)
    # offset within bounds but length running past the end: same refusal
    struct.pack_into(">QQ", payload, desc_at, 0, 1 << 40)
    with pytest.raises(FrameError, match="outside"):
        decode_shm_payload(bytes(payload), shm_pool.resolve)


def test_torch_shm_unknown_segment_refused(shm_pool):
    """A frame naming a segment this connection does not own is refused
    (resolve returns None for anything outside the connection's pool)."""
    payload = _shm_payload(_SHM_MSG, shm_pool)
    with pytest.raises(FrameError, match="unknown segment"):
        decode_shm_payload(payload, lambda name: None)


def test_torch_shm_garbage_payloads_rejected(shm_pool):
    rng = np.random.default_rng(3)
    for n in (0, 1, 9, 64, 400):
        blob = bytes(rng.integers(0, 256, n, dtype=np.uint8).tolist())
        with pytest.raises(FrameError):
            decode_shm_payload(KIND_SHM + blob, shm_pool.resolve)


def test_torch_shm_kind_refused_by_plain_decode(shm_pool):
    """decode_message (the un-negotiated path) refuses 'S' payloads: a
    connection that never said hello cannot make the server touch shm."""
    payload = _shm_payload(_SHM_MSG, shm_pool)
    with pytest.raises(FrameError, match="unknown message kind"):
        decode_message(payload)


def test_torch_shm_pool_recycles_when_arrays_die():
    """Segments are pooled: once every array decoded out of a segment dies,
    the same segment serves the next lease instead of a new allocation."""
    pool = _ShmPool()
    try:
        names = set()
        for _ in range(5):
            payload = _shm_payload((b"k", _make_array(np.float32, (64, 64))),
                                   pool)
            got, name = decode_shm_payload(payload, pool.resolve)
            pool.track(name, got)
            names.add(name)
            del got                        # last view dies -> refs drop to 0
        assert len(names) == 1             # one segment, five leases
        assert pool.segment_count() == 1
    finally:
        pool.release_all()


# -- hypothesis widening -----------------------------------------------------

_dtype_strategy = st.sampled_from(_DTYPES)
_shape_strategy = st.lists(st.integers(0, 5), min_size=0, max_size=3) \
    .map(tuple)


@given(payload=st.binary(max_size=5000))
@settings(max_examples=50, deadline=None)
def test_torch_property_pickle_kind_roundtrip(payload):
    assert _eq(_roundtrip((payload, len(payload))), (payload, len(payload)))


@given(dtype=_dtype_strategy, shape=_shape_strategy,
       seed=st.integers(0, 2 ** 16), fortran=st.booleans())
@settings(max_examples=60, deadline=None)
def test_torch_property_array_kind_roundtrip(dtype, shape, seed, fortran):
    arr = _make_array(dtype, shape, seed=seed)
    if fortran and arr.ndim > 1:
        arr = np.asfortranarray(arr)
    got = _roundtrip((b"k", arr))[1]
    assert _eq(got, arr)


@given(cut=st.integers(0, len(_frame_bytes(_TRUNC_MSG))))
@settings(max_examples=60, deadline=None)
def test_torch_property_truncation_never_garbage(cut):
    _check_truncation(cut)


@given(byte_idx=st.integers(0, len(_frame_bytes(_TRUNC_MSG)) - 1),
       bit=st.integers(0, 7))
@settings(max_examples=80, deadline=None)
def test_torch_property_bit_flip_never_garbage(byte_idx, bit):
    _check_bit_flip(byte_idx, bit)
