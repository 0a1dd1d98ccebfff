"""Per-topic payload codecs, the counterpart of ``repro/data/codec.py``:
compress detector frames at the source→broker boundary, decode at
subscribe.

A topic created with ``codec="int8"`` (or ``IngestConfig(codec=...)``) has
its record *values* encoded by :class:`~repro_torch.data.ingest.IngestRunner`
before they reach the broker, and decoded by ``StreamingContext`` /
``TopicSource`` when consumed. The broker never looks inside a value, so
``DurablePartitionLog`` segments carry codec'd payloads verbatim.

Encoded values are *self-describing*: a dict whose ``"__codec__"`` key names
the codec, so :func:`maybe_decode` needs no topic configuration (an O(1)
isinstance + key check on the consume path) and a consumer reading a mixed
log of raw and codec'd records decodes each correctly. An encoded value
naming a codec this process does not know is refused with
:class:`UnknownCodecError`, never passed through. The encoded values are
the reference's byte for byte, so each package decodes the other's.

Codecs:

- ``raw`` — identity; the default for every topic not configured otherwise.
- ``int8`` — *lossy* symmetric per-tensor quantization (the NumPy mirror of
  the reference's ``repro.optim.compression.quantize_int8``): float arrays
  anywhere in the value shrink 4x (float32) with per-element error
  ≤ ``amax/127``. The int8 payload arrays still ride the transport's
  out-of-band buffer path (``'A'``/``'S'`` frames).
- ``zlib`` — lossless byte-level compression of the whole pickled value.
  Decode goes through the transport's *restricted* unpickler: bytes that
  came off the wire stay inside the wire's trust boundary (see
  :func:`repro_torch.data.transport.register_safe`).
"""
from __future__ import annotations

import pickle
import zlib as _zlib
from typing import Any, Callable

import numpy as np

from repro_torch.core.broker import Record
from repro_torch.data.transport import _ERR_TYPES, _restricted_load

# The self-description key on encoded values. A *raw-topic* user value that
# happens to be a dict carrying this key is wrapped by the raw codec on
# encode (and unwrapped on decode) so it can never be mistaken for an
# encoded payload.
SENTINEL = "__codec__"

# Marker key for a quantized array node inside an int8-encoded value.
_Q8 = "__q8__"


class UnknownCodecError(ValueError):
    """An encoded value (or a ``create_topic``/``IngestConfig``) names a
    codec this process has no decoder for — refused, never passed through
    as-is or guessed at."""


# a remote create_topic with a bad codec name must raise the same type the
# in-process broker does (the parity matrix pins this), so the transport
# needs to reconstruct it from the error frame
_ERR_TYPES["UnknownCodecError"] = UnknownCodecError


class Codec:
    """One payload codec: ``encode`` runs producer-side at the ingest flush
    boundary, ``decode`` consumer-side at subscribe. Both take and return a
    record *value* (any restricted-pickle-safe object)."""

    name: str = "?"

    def encode(self, value: Any) -> Any:
        raise NotImplementedError

    def decode(self, wrapped: Any) -> Any:
        raise NotImplementedError


class RawCodec(Codec):
    """Identity, except for escaping user dicts that collide with the
    sentinel key (so raw values round-trip byte-exactly through consumers
    that :func:`maybe_decode` everything)."""

    name = "raw"

    def encode(self, value: Any) -> Any:
        if isinstance(value, dict) and SENTINEL in value:
            return {SENTINEL: self.name, "v": value}
        return value

    def decode(self, wrapped: Any) -> Any:
        return wrapped["v"]


def _quantize(arr: np.ndarray) -> dict:
    """NumPy mirror of the reference's
    ``repro.optim.compression.quantize_int8`` (pinned against it by a
    parity test): symmetric per-tensor int8."""
    x32 = np.asarray(arr, dtype=np.float32)
    amax = float(np.max(np.abs(x32))) if x32.size else 0.0
    scale = max(amax / 127.0, 1e-12)
    q = np.clip(np.round(x32 / scale), -127, 127).astype(np.int8)
    return {_Q8: 1, "q": q, "s": scale, "d": str(arr.dtype)}


def _dequantize(node: dict) -> np.ndarray:
    out = node["q"].astype(np.float32) * node["s"]
    return out.astype(node["d"], copy=False)


class Int8Codec(Codec):
    """Lossy: every floating-point ndarray in the value is replaced by its
    int8 quantization (4x smaller for float32, 8x for float64); everything
    else passes through untouched. Error per element is bounded by the
    tensor's ``amax/127`` — fine for detector frames feeding iterative
    solvers, wrong for control data, which is why codecs are per-topic."""

    name = "int8"

    def _walk_enc(self, v: Any) -> Any:
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            return _quantize(v)
        if isinstance(v, dict):
            return {k: self._walk_enc(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(self._walk_enc(x) for x in v)
        return v

    def _walk_dec(self, v: Any) -> Any:
        if isinstance(v, dict):
            if _Q8 in v:
                return _dequantize(v)
            return {k: self._walk_dec(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(self._walk_dec(x) for x in v)
        return v

    def encode(self, value: Any) -> Any:
        return {SENTINEL: self.name, "v": self._walk_enc(value)}

    def decode(self, wrapped: Any) -> Any:
        return self._walk_dec(wrapped["v"])


class ZlibCodec(Codec):
    """Lossless byte-level compression of the whole pickled value. Decode
    goes through the transport's restricted unpickler — the compressed blob
    crossed the wire, so it gets exactly the wire's trust model (values with
    custom classes need ``transport.register_safe`` on the consumer, same as
    they would to cross the socket raw)."""

    name = "zlib"

    def __init__(self, level: int = 1) -> None:
        self.level = level             # speed over ratio: this is a hot path

    def encode(self, value: Any) -> Any:
        blob = pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
        return {SENTINEL: self.name, "z": _zlib.compress(blob, self.level)}

    def decode(self, wrapped: Any) -> Any:
        return _restricted_load(_zlib.decompress(wrapped["z"]))


_CODECS: dict[str, Codec] = {}


def register_codec(codec: Codec) -> Codec:
    """Add a codec to the registry (both sides: producers that encode with
    it and consumers that will meet its name in ``__codec__``)."""
    _CODECS[codec.name] = codec
    return codec


register_codec(RawCodec())
register_codec(Int8Codec())
register_codec(ZlibCodec())


def codec_names() -> list[str]:
    return sorted(_CODECS)


def get_codec(name: str) -> Codec:
    try:
        return _CODECS[name]
    except KeyError:
        raise UnknownCodecError(
            f"unknown codec {name!r} (known: {codec_names()}; "
            "see repro_torch.data.codec.register_codec)") from None


def maybe_decode(value: Any) -> Any:
    """Decode ``value`` if it is a codec-wrapped payload, else return it
    unchanged. O(1) for unwrapped values — safe on every consume path."""
    if isinstance(value, dict) and SENTINEL in value:
        return get_codec(value[SENTINEL]).decode(value)
    return value


def compose_decoder(decoder: Callable[[Any], Any] | None
                    ) -> Callable[[Any], Any]:
    """Codec decode first, then the user's value decoder (if any) — what
    ``StreamingContext`` applies to every consumed record value."""
    if decoder is None:
        return maybe_decode
    return lambda v: decoder(maybe_decode(v))


class CodecBroker:
    """Transparent encode/decode adapter around any broker duck type:
    ``produce``/``produce_many`` encode values, ``read`` decodes them —
    every other call passes through. With a lossless codec this is
    observationally identical to the wrapped broker, which is exactly what
    the ``codec`` row of the broker contract-parity matrix pins."""

    def __init__(self, broker: Any, codec: str = "zlib") -> None:
        self._broker = broker
        self._codec = get_codec(codec)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._broker, name)

    def produce(self, topic: str, value: Any, **kwargs: Any) -> int:
        return self._broker.produce(topic, self._codec.encode(value),
                                    **kwargs)

    def _encode_pair(self, pair: Any) -> Any:
        try:
            k, v = pair
        except (TypeError, ValueError):
            return pair                # malformed: the broker's validation
        return (k, self._codec.encode(v))  # raises, preserving its error type

    def produce_many(self, topic: str, pairs, **kwargs: Any) -> list[int]:
        enc = [self._encode_pair(p) for p in pairs]
        return self._broker.produce_many(topic, enc, **kwargs)

    def read(self, rng) -> list:
        return [Record(r.key, maybe_decode(r.value), r.offset, r.timestamp)
                for r in self._broker.read(rng)]

    def close(self) -> None:
        close = getattr(self._broker, "close", None)
        if close is not None:
            close()
