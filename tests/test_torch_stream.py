"""The port's streaming path on the CPU: the §III entry point end to end,
replayed against the reference's solver, and the trimmed broker and
micro-batch stream against the contracts of tests/test_broker_dstream.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps.ptycho import sim as jsim
from repro.apps.ptycho import solver as jsolver
from repro_torch.apps.ptycho.stream import parse_args, run_stream
from repro_torch.core.bridge import TorchBridge
from repro_torch.core.broker import Broker, OffsetRange, create_rdd
from repro_torch.core.dstream import StreamingContext
from repro_torch.core.pipeline import NearRealTimePipeline, PipelineConfig
from repro_torch.core.rdd import Context
from repro_torch.data.sinks import NpzDirectorySink
from repro_torch.data.sources import DetectorSource


@pytest.fixture(scope="module")
def fast_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("stream")
    args = parse_args(["--fast", "--out", str(out)])
    return args, run_stream(args, device="cpu")


def test_torch_stream_fast_drains_every_frame(fast_run):
    args, res = fast_run
    assert res["frames_seen"][-1] == 81
    assert res["frames_seen"] == sorted(res["frames_seen"])
    assert res["report"].records == 81
    assert res["report"].batches == len(res["batch_errors"])
    assert res["iterations"] == (len(res["batch_errors"])
                                 * args.iters_per_batch + args.final_iters)
    assert res["launches"] == {"modulus_project": 0, "overlap_products": 0,
                               "raar_combine": 0,       # CPU: plain versions
                               "art_sweep": 0,          # not on this path
                               "flash_attention": 0}
    assert np.isfinite(res["final_error"])
    assert res["final_error"] < res["batch_errors"][0]
    assert res["quality"] > 0.9


def test_torch_stream_sink_is_idempotent(fast_run):
    """One npz per batch plus object-final; a rerun into the same directory
    rewrites only object-final and does not grow the count."""
    args, res = fast_run
    batches = len(res["batch_errors"])
    want = [f"batch-{i:06d}" for i in range(batches)] + ["object-final"]
    assert res["sink_keys"] == want
    again = run_stream(args, device="cpu")
    assert again["sink_keys"] == want
    # the same sums in the same order: the scatter-adds run in index order
    # (sim.accumulate_patches), so a rerun repeats every bit
    np.testing.assert_array_equal(again["batch_errors"], res["batch_errors"])
    sink = NpzDirectorySink(f"{args.out}/ptycho")
    with np.load(sink.path_for("object-final")) as z:
        assert z["obj"].shape == (args.obj_size, args.obj_size)
        assert z["obj"].dtype == np.complex64
    with np.load(sink.path_for("batch-000000")) as z:
        assert int(z["frames_seen"]) == res["frames_seen"][0]


def test_torch_stream_renders_the_phase_image(fast_run, tmp_path):
    """The run ends with paper Fig. 10, the final object's phase, as
    ``examples/ptycho_pipeline.py`` does; ``render_phase`` writes the
    reference's array for the same object."""
    from repro.apps.tomo.render import render_phase as jax_render_phase
    from repro_torch.apps.tomo.render import render_phase

    args, res = fast_run
    paths = res["artifacts"]
    assert paths[0] == f"{args.out}/ptycho_phase.npy"
    sink = NpzDirectorySink(f"{args.out}/ptycho")
    with np.load(sink.path_for("object-final")) as z:
        np.testing.assert_array_equal(np.load(paths[0]), np.angle(z["obj"]))
    rng = np.random.default_rng(3)
    obj = (rng.standard_normal((24, 24))
           + 1j * rng.standard_normal((24, 24))).astype(np.complex64)
    got = render_phase(obj, str(tmp_path / "port"))
    want = jax_render_phase(obj, str(tmp_path / "ref"))
    assert [p.rsplit("/", 1)[1] for p in got] == \
        [p.rsplit("/", 1)[1] for p in want]
    np.testing.assert_array_equal(np.load(got[0]), np.load(want[0]))


def test_torch_stream_batch_errors_match_jax_replay(fast_run):
    """The reference's raar_step, replayed on the port's batch boundaries,
    gives the same per-batch Fourier errors."""
    args, res = fast_run
    prob = jsim.simulate(args.obj_size, args.probe_size, args.scan_step)
    cfg = jsolver.SolverConfig(beta=0.75, use_pallas=False)
    obj_shape = prob.object_true.shape
    step = jax.jit(lambda psi, mag, pos, probe, it: jsolver.raar_step(
        psi, mag, pos, probe, obj_shape, cfg, it))
    positions = jnp.asarray(prob.positions)
    probe, psi, n_seen, it = prob.probe_true, None, 0, 0
    errs = []
    for n_new in res["frames_seen"]:
        fresh = jsolver.init_waves(prob.magnitudes[n_seen:n_new], probe)
        psi = fresh if psi is None else jnp.concatenate([psi, fresh])
        for _ in range(args.iters_per_batch):
            psi, _, probe, err = step(psi, prob.magnitudes[:n_new],
                                      positions[:n_new], probe, it)
            it += 1
        errs.append(float(err))
        n_seen = n_new
    np.testing.assert_allclose(res["batch_errors"], errs, rtol=0, atol=1e-3)


def test_torch_pipeline_without_bridge_wants_cuda(monkeypatch):
    """The default bridge is on the card; without one the pipeline raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        NearRealTimePipeline(Broker(), PipelineConfig(), lambda *a: None)
    cpu = TorchBridge(device=torch.device("cpu"))
    NearRealTimePipeline(Broker(), PipelineConfig(), lambda *a: None,
                         bridge=cpu)


# -- the trimmed broker and stream (tests/test_broker_dstream.py) -------------
def test_torch_partition_order_and_offsets():
    b = Broker()
    b.create_topic("t", 2)
    for i in range(10):
        b.produce("t", i, partition=i % 2)
    recs = b.read(OffsetRange("t", 0, 0, 5))
    assert [r.value for r in recs] == [0, 2, 4, 6, 8]
    assert [r.offset for r in recs] == list(range(5))
    assert b.end_offsets("t") == [5, 5]


def test_torch_produce_many_validates_before_appending():
    b = Broker()
    b.create_topic("t", 2)
    assert b.produce_many("t", [(b"k0", 0), (b"k1", 1)], partition=1) == [0, 1]
    with pytest.raises(ValueError, match="key, value"):
        b.produce_many("t", [(b"k2", 2), "not-a-pair"], partition=1)
    assert b.end_offsets("t") == [0, 2]      # nothing of the bad batch landed
    with pytest.raises(ValueError, match="out of range"):
        b.produce_many("t", [(b"k", 0)], partition=2)


def test_torch_detector_source_replays_frames_from_the_host_copy():
    """Frames are read from the problem's host copy of the magnitudes, so a
    problem on the card can feed a source; ``seek`` replays."""
    from repro_torch.apps.ptycho.sim import simulate
    prob = simulate(obj_size=48, probe_size=16, step=8, device="cpu")
    src = DetectorSource(prob, max_frames=5, emit_frames=True)
    first = src.poll(3)
    assert [k for k, _ in first] == [b"frame-000000", b"frame-000001",
                                     b"frame-000002"]
    i, frame = first[1][1]
    assert i == 1 and isinstance(frame, np.ndarray)
    np.testing.assert_array_equal(frame, prob.magnitudes_host[1])
    assert len(src.poll(10)) == 2 and src.exhausted
    src.seek(4)
    assert [v[0] for _, v in src.poll(10)] == [4]
    with pytest.raises(ValueError):
        src.seek(6)


def test_torch_offset_range_reads_are_replayable():
    b = Broker()
    b.create_topic("t", 1)
    for i in range(8):
        b.produce("t", i)
    ctx = Context()
    r1 = create_rdd(ctx, b, [OffsetRange("t", 0, 2, 6)])
    r2 = create_rdd(ctx, b, [OffsetRange("t", 0, 2, 6)])
    assert r1.collect() == r2.collect() == [2, 3, 4, 5]


def test_torch_microbatch_union_across_topics():
    b = Broker()
    b.create_topic("a", 1)
    b.create_topic("b", 2)
    for i in range(6):
        b.produce("a", ("a", i))
        b.produce("b", ("b", i), partition=i % 2)
    ctx = Context()
    sc = StreamingContext(ctx, b)
    sc.subscribe(["a", "b"])
    seen = []
    sc.foreach_batch(lambda rdd, info: seen.extend(rdd.collect()))
    info = sc.run_one_batch()
    assert info.num_records == 12
    assert sorted(x[1] for x in seen if x[0] == "a") == list(range(6))
    assert sorted(x[1] for x in seen if x[0] == "b") == list(range(6))
    assert sc.run_one_batch() is None      # drained


def test_torch_serial_sink_runs_before_commit():
    """A raising sink leaves the offsets untouched, here and broker-side,
    and the batch replays to every sink."""
    b = Broker()
    b.create_topic("t", 1)
    for i in range(4):
        b.produce("t", i)
    sc = StreamingContext(Context(), b)
    sc.subscribe(["t"])
    sc.foreach_batch(lambda rdd, info: rdd.collect())
    events = []
    sc.add_sink(lambda info: events.append(("sink", list(info.result))))

    armed = {"boom": True}

    def exploding(info):
        events.append(("boom", list(info.result)))
        if armed.pop("boom", False):
            raise RuntimeError("sink died")

    sc.add_sink(exploding)
    with pytest.raises(RuntimeError):
        sc.run_one_batch()
    assert sc.committed("t") == 0
    assert b.committed("t") == [0]
    assert sc.history == []                # the batch did not count
    info = sc.run_one_batch()              # replay delivers to every sink
    assert info.result == [0, 1, 2, 3]
    assert events == [("sink", [0, 1, 2, 3]), ("boom", [0, 1, 2, 3]),
                      ("sink", [0, 1, 2, 3]), ("boom", [0, 1, 2, 3])]
    assert sc.committed("t") == 4 and b.committed("t") == [4]
