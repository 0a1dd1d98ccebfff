"""The port's payload codecs (repro_torch.data.codec) on the CPU: the
counterparts of tests/test_codec.py — round trips, the lossy int8 bound,
parity with the JAX quantizer, unknown-codec refusal, encode at the ingest
flush and decode at subscribe — and the same values through the JAX
package and the port, whose encoded bytes must be equal and which must each
decode the other's.

Every test runs with the port's lock tracing on and asserts afterwards that
the locks it took were acquired in no cyclic order.
"""
import os

import numpy as np
import pytest

from repro.core.broker import Broker as JaxBroker
from repro.core.broker import OffsetRange as JaxOffsetRange
from repro.data import codec as jax_codec
from repro.data import durable_log as jax_durable_log
from repro.data import transport as jax_transport
from repro_torch.core.broker import Broker, OffsetRange
from repro_torch.core.dstream import StreamingContext
from repro_torch.core.rdd import Context
from repro_torch.data import locktrace
from repro_torch.data import transport as port_transport
from repro_torch.data.codec import (SENTINEL, CodecBroker, UnknownCodecError,
                                    codec_names, compose_decoder, get_codec,
                                    maybe_decode)


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


# -- round trips (tests/test_codec.py) -----------------------------------------

_VALUES = [
    7,
    "text",
    b"raw-bytes",
    None,
    {"i": 1, "nested": (2.5, [b"x", None])},
    (3, np.arange(12, dtype=np.float32).reshape(3, 4)),
    {"frame": np.ones((4, 4), dtype=np.float64),
     "meta": {"idx": [np.arange(5, dtype=np.int64)]}},
]


def _eq(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_eq(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_eq(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def test_torch_codec_registry_names():
    assert codec_names() == ["int8", "raw", "zlib"] == jax_codec.codec_names()


@pytest.mark.parametrize("name", ["raw", "zlib"])
def test_torch_codec_lossless_roundtrip(name):
    codec = get_codec(name)
    for value in _VALUES:
        assert _eq(maybe_decode(codec.encode(value)), value)


def test_torch_codec_int8_roundtrip_structure_and_integers_exact():
    codec = get_codec("int8")
    value = {"frame": np.linspace(-1, 1, 16, dtype=np.float32).reshape(4, 4),
             "idx": np.arange(6, dtype=np.int32), "n": 3, "tag": "t"}
    got = maybe_decode(codec.encode(value))
    assert got.keys() == value.keys()
    assert np.array_equal(got["idx"], value["idx"])   # integers untouched
    assert got["n"] == 3 and got["tag"] == "t"
    assert got["frame"].dtype == np.float32
    assert got["frame"].shape == (4, 4)


def test_torch_codec_int8_lossy_error_bound():
    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.float64):
        for scale_up in (1e-3, 1.0, 1e4):
            arr = (rng.standard_normal((64, 64)) * scale_up).astype(dtype)
            got = maybe_decode(get_codec("int8").encode(arr))
            bound = float(np.max(np.abs(arr))) / 127.0 + 1e-9
            assert float(np.max(np.abs(got.astype(np.float64)
                                       - arr.astype(np.float64)))) <= bound


def test_torch_codec_int8_empty_and_zero_arrays():
    for arr in (np.zeros((3, 3), dtype=np.float32),
                np.zeros((0,), dtype=np.float32)):
        got = maybe_decode(get_codec("int8").encode(arr))
        assert got.shape == arr.shape and np.array_equal(got, arr)


def test_torch_codec_int8_matches_jax_reference():
    """The port's quantizer gives the JAX ``quantize_int8``'s q arrays and
    scales, and the reference codec's nodes exactly."""
    import jax
    from repro.optim.compression import dequantize_int8, quantize_int8
    from repro_torch.data.codec import _quantize

    rng = np.random.default_rng(1)
    for x in (rng.standard_normal((32, 32)).astype(np.float32),
              np.zeros((8,), dtype=np.float32),
              (rng.standard_normal(100) * 1e-6).astype(np.float32)):
        node = _quantize(x)
        q_jax, scale_jax = quantize_int8(jax.numpy.asarray(x))
        np.testing.assert_array_equal(node["q"], np.asarray(q_jax))
        assert node["s"] == pytest.approx(float(scale_jax), rel=1e-6)
        np.testing.assert_allclose(
            node["q"].astype(np.float32) * node["s"],
            np.asarray(dequantize_int8(q_jax, scale_jax)), rtol=1e-6)
        ref = jax_codec._quantize(x)
        np.testing.assert_array_equal(node["q"], ref["q"])
        assert node["s"] == ref["s"] and node["d"] == ref["d"]


# -- refusal and escaping --------------------------------------------------------

def test_torch_codec_unknown_codec_refused_everywhere():
    with pytest.raises(UnknownCodecError, match="martian"):
        get_codec("martian")
    with pytest.raises(UnknownCodecError):
        maybe_decode({SENTINEL: "martian", "v": 1})   # never passed through
    with pytest.raises(UnknownCodecError):
        Broker().create_topic("t", codec="martian")   # fails at create...


def test_torch_codec_unknown_codec_refused_over_the_wire(tmp_path):
    """...and the same error type crosses the transport from a remote
    create_topic (registered in the transport's typed-error table)."""
    server = port_transport.serve_broker(Broker(), str(tmp_path / "b.sock"))
    client = port_transport.RemoteBroker(server.address)
    try:
        with pytest.raises(UnknownCodecError):
            client.create_topic("t", codec="martian")
        client.create_topic("t", codec="int8")        # good names still work
        assert client.topic_codec("t") == "int8"
        with pytest.raises(KeyError):
            client.topic_codec("missing")
    finally:
        client.close()
        server.stop()


def test_torch_codec_sentinel_collision_escaped():
    tricky = {SENTINEL: "zlib", "z": b"not really compressed"}
    wrapped = get_codec("raw").encode(tricky)
    assert wrapped is not tricky                      # escaped, not aliased
    assert _eq(maybe_decode(wrapped), tricky)
    plain = {"k": 1}
    assert get_codec("raw").encode(plain) is plain


def test_torch_codec_compose_decoder_order():
    codec = get_codec("zlib")
    dec = compose_decoder(lambda v: v * 10)
    assert dec(codec.encode(7)) == 70
    assert dec(3) == 30                               # unwrapped passthrough
    assert compose_decoder(None)(codec.encode("x")) == "x"


# -- topic configuration and the encode/decode boundary ----------------------------

def test_torch_codec_topic_codec_configuration():
    b = Broker()
    b.create_topic("detector", codec="int8")
    b.create_topic("control")
    assert b.topic_codec("detector") == "int8"
    assert b.topic_codec("control") is None
    with pytest.raises(KeyError):
        b.topic_codec("missing")


def test_torch_codec_ingest_encodes_subscribe_decodes():
    from repro_torch.data.ingest import IngestConfig, IngestRunner
    from repro_torch.data.sources import SequenceSource

    class Frames(SequenceSource):
        def __init__(self, n):
            super().__init__()
            rng = np.random.default_rng(2)
            self.frames = [rng.standard_normal((8, 8)).astype(np.float32)
                           for _ in range(n)]

        def __len__(self):
            return len(self.frames)

        def record_at(self, i):
            return f"f{i}".encode(), (i, self.frames[i])

    broker = Broker()
    runner = IngestRunner(broker)
    source = Frames(6)
    m = runner.add(source, IngestConfig(topic="det", codec="int8",
                                        flush_records=3))
    runner.run_inline(timeout=30)
    assert m.produced == 6
    raw = broker.read(OffsetRange("det", 0, 0, 10))
    assert all(isinstance(r.value, dict) and r.value[SENTINEL] == "int8"
               for r in raw)
    sc = StreamingContext(Context(), broker, max_records_per_partition=10)
    sc.subscribe(["det"])
    seen = []
    sc.foreach_batch(lambda rdd, info: seen.extend(rdd.collect()))
    sc.run_batches(1)
    assert len(seen) == 6
    for i, frame in sorted(seen):
        ref = source.frames[i]
        assert frame.dtype == np.float32
        assert np.max(np.abs(frame - ref)) <= np.max(np.abs(ref)) / 127 + 1e-9


def test_torch_codec_topic_source_decodes_for_chained_stages():
    from repro_torch.data.sources import TopicSource

    broker = Broker()
    broker.create_topic("stage1", codec="zlib")
    codec = get_codec("zlib")
    broker.produce("stage1", codec.encode({"x": 1}), key=b"a")
    broker.produce("stage1", codec.encode((2, np.arange(3))), key=b"b")
    got = TopicSource(broker, "stage1", stop_at_end=True).poll(10)
    assert _eq(got[0], (b"a", {"x": 1}))
    assert _eq(got[1], (b"b", (2, np.arange(3))))


def test_torch_codec_metrics_account_reduction():
    from repro_torch.data.ingest import IngestConfig, IngestRunner
    from repro_torch.data.metrics import MetricsRegistry, set_registry
    from repro_torch.data.sources import SequenceSource

    class Frames(SequenceSource):
        def __len__(self):
            return 4

        def record_at(self, i):
            return None, np.ones((64, 64), dtype=np.float32)

    reg = MetricsRegistry()
    prev = set_registry(reg)
    try:
        runner = IngestRunner(Broker())
        runner.add(Frames(), IngestConfig(topic="t", codec="int8",
                                          flush_records=2))
        runner.run_inline(timeout=30)
        values = {m.name: m.value() for m in reg.metrics()}
        bytes_in = values["ingest_codec_bytes_in"]
        bytes_out = values["ingest_codec_bytes_out"]
        assert bytes_in >= 4 * 64 * 64 * 4
        assert bytes_out < bytes_in / 3           # ~4x minus wrapper overhead
    finally:
        set_registry(prev)


# -- composition with durability ---------------------------------------------------

def test_torch_codec_durable_log_byte_identity_with_codec(tmp_path):
    """The port's counterpart of the reference's replication test: codec'd
    payloads are opaque to the broker, so the same compressed topic written
    through the port's durable log and the reference's lands byte-identical
    segment files, a port follower replicating the port's log over a Unix
    socket holds the same bytes, and every log's records decode to the
    values."""
    from repro_torch.data.durable_log import DurableLogFactory
    from repro_torch.data.replication import ReplicaFollower
    from repro_torch.data.transport import serve_broker

    values = [{"i": i, "blob": b"x" * 200} for i in range(30)]
    pairs = [(f"k{i}".encode(), get_codec("zlib").encode(v))
             for i, v in enumerate(values)]
    port = Broker(log_factory=DurableLogFactory(str(tmp_path / "port")))
    port.create_topic("t", 2, codec="zlib")
    port.produce_many("t", pairs)
    ref = JaxBroker(log_factory=jax_durable_log.DurableLogFactory(
        str(tmp_path / "ref")))
    ref.create_topic("t", 2, codec="zlib")
    ref.produce_many("t", [(k, jax_codec.get_codec("zlib").encode(v))
                           for (k, _), v in zip(pairs, values)])
    assert port.end_offsets("t") == ref.end_offsets("t")
    server = serve_broker(port, str(tmp_path / "p.sock"))
    fol = ReplicaFollower(server.address, str(tmp_path / "replica"))
    try:
        while fol.sync_once():
            pass
        for p in range(2):
            pdir = tmp_path / "port" / "t" / f"p{p:04d}"
            segs = sorted(f for f in os.listdir(pdir) if f.endswith(".seg"))
            for other in ("ref", "replica"):
                odir = tmp_path / other / "t" / f"p{p:04d}"
                assert segs == sorted(f for f in os.listdir(odir)
                                      if f.endswith(".seg"))
                for seg in segs:
                    assert (pdir / seg).read_bytes() == \
                        (odir / seg).read_bytes()
        got = []
        for p in range(2):
            end = port.end_offset("t", p)
            got += [maybe_decode(r.value)
                    for r in port.read(OffsetRange("t", p, 0, end))]
            got += [maybe_decode(r.value)
                    for r in fol.broker.read(OffsetRange("t", p, 0, end))]
            got += [jax_codec.maybe_decode(r.value)
                    for r in ref.read(JaxOffsetRange("t", p, 0, end))]
        assert sorted(v["i"] for v in got) == sorted(3 * list(range(30)))
    finally:
        fol.stop()
        server.stop()


def test_torch_codec_broker_adapter_passthrough():
    cb = CodecBroker(Broker(), codec="zlib")
    cb.create_topic("t", 2)
    assert cb.num_partitions("t") == 2
    cb.produce("t", {"a": 1}, partition=0)
    cb.produce_many("t", [(b"k", np.arange(4))], partition=0)
    recs = cb.read(OffsetRange("t", 0, 0, 10))
    assert _eq(recs[0].value, {"a": 1})
    assert _eq(recs[1].value, np.arange(4))
    inner = cb._broker.read(OffsetRange("t", 0, 0, 10))
    assert all(isinstance(r.value, dict) and r.value[SENTINEL] == "zlib"
               for r in inner)


# -- the same values through both packages -----------------------------------------

def _seeded_values():
    rng = np.random.default_rng(3)
    frame = rng.standard_normal((16, 16)).astype(np.float32)
    return [frame, (7, frame), {"frame": frame.astype(np.float64),
                                "idx": np.arange(5, dtype=np.int64),
                                "tag": "det"}]


@pytest.mark.parametrize("name", ["raw", "zlib", "int8"])
def test_torch_codec_encoded_bytes_equal_the_reference(name):
    """Encoding the same arrays through each package's codec gives the same
    value, and the same message bytes on the wire."""
    for value in _seeded_values():
        port = get_codec(name).encode(value)
        ref = jax_codec.get_codec(name).encode(value)
        assert _eq(port, ref)
        assert (b"".join(bytes(p) for p in port_transport.encode_message(port))
                == b"".join(bytes(p)
                            for p in jax_transport.encode_message(ref)))


@pytest.mark.parametrize("name", ["raw", "zlib", "int8"])
def test_torch_codec_each_package_decodes_the_others_values(name):
    """A value the reference encoded, sent through the reference's message
    codec, decodes in the port to what the reference decodes it to, and
    the reverse."""
    for value in _seeded_values():
        ref_wire = b"".join(bytes(p) for p in jax_transport.encode_message(
            jax_codec.get_codec(name).encode(value)))
        port_wire = b"".join(bytes(p) for p in port_transport.encode_message(
            get_codec(name).encode(value)))
        want = jax_codec.maybe_decode(
            jax_transport.decode_message(bytearray(ref_wire)))
        assert _eq(maybe_decode(port_transport.decode_message(
            bytearray(ref_wire))), want)
        assert _eq(jax_codec.maybe_decode(jax_transport.decode_message(
            bytearray(port_wire))), maybe_decode(
                port_transport.decode_message(bytearray(port_wire))))
