"""The port's §IV tomography path against the reference, on the CPU.

Every input is made with numpy from a seed and handed to both packages. The
port's ART sweep (its plain PyTorch version, what ``ops`` runs on a CPU
tensor) is held against the JAX ``ref.py`` and the Pallas kernel in
interpret mode with the shapes and tolerance of ``tests/test_kernels.py``;
the projector, the phantom, the slice solver and the streaming entry point
against ``repro.apps.tomo``; and the host pieces the path adds (the
projection source, ``parallelize``/``map_partitions``) against the
reference's. The CUDA kernel itself needs the card: ``chip_smoke.py`` holds
it against the plain version there. The kernel reads the system as CSR:
``csr_rows`` is held to the dense A it comes from, and a model of the
kernel's sweep written here (lane-strided partial dots over the non-zeros
and a butterfly sum) to the JAX sweep.
"""
import pathlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps.tomo import projector as jproj
from repro.apps.tomo import solver as jsolver
from repro.core import rdd as jrdd
from repro.data import sources as jsources
from repro.kernels.art import kernel as jart_kernel
from repro.kernels.art import ops as jart_ops
from repro.kernels.art import ref as jart_ref
from repro_torch.apps.tomo import projector as tproj
from repro_torch.apps.tomo import solver as tsolver
from repro_torch.apps.tomo.stream import parse_args, run_stream
from repro_torch.core.rdd import Context
from repro_torch.data.sinks import NpzDirectorySink
from repro_torch.data.sources import ProjectionSource
from repro_torch.kernels.art import ops as tart_ops
from repro_torch.kernels.art import ref as tart_ref

TOL = dict(rtol=1e-4, atol=1e-4)          # tests/test_kernels.py:107


def _rng(*parts):
    return np.random.default_rng(zlib.crc32(repr(parts).encode()))


def _system(rng, nrow, ncol, nslice):
    """A random consistent system: A, b = f_true·Aᵀ and 1/‖A_j‖², fp32."""
    A = rng.standard_normal((nrow, ncol)).astype(np.float32)
    f_true = rng.standard_normal((nslice, ncol)).astype(np.float32)
    b = (f_true @ A.T).astype(np.float32)
    inv_rip = (1.0 / (A * A).sum(axis=1)).astype(np.float32)
    return A, b, inv_rip


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _angles(n):
    return tuple(np.linspace(-75, 75, n).tolist())


# -- the kernel's function ----------------------------------------------------
@pytest.mark.parametrize("nrow,ncol", [(8, 16), (20, 12), (32, 64)])
@pytest.mark.parametrize("iters", [1, 3])
def test_torch_art_sweep_matches_jax(nrow, ncol, iters):
    A, b, inv_rip = _system(_rng("art", nrow, ncol), nrow, ncol, 1)
    f0 = np.zeros((1, ncol), np.float32)
    got = tart_ref.art_sweep_ref(*_t(A, b, inv_rip, f0), beta=1.0,
                                 iters=iters)
    ja = [jnp.asarray(x) for x in (A, b[0], inv_rip, f0[0])]
    pallas = jart_kernel.art_sweep(*ja, beta=1.0, iters=iters,
                                   interpret=True)
    ref = jart_ref.art_sweep_ref(*ja, beta=1.0, iters=iters)
    assert got.shape == (1, ncol)
    for want in (pallas, ref):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("beta", [0.5, 1.5])
def test_torch_art_sweep_batched_slices_match_single_jax_calls(beta):
    """The batch axis of slices stands where the reference vmaps one slice:
    each row of the batched result equals the single-slice JAX call, from a
    non-zero start and with β ≠ 1."""
    rng = _rng("art-batch", beta)
    A, b, inv_rip = _system(rng, 24, 20, 4)
    f0 = rng.standard_normal((4, 20)).astype(np.float32)
    got = tart_ref.art_sweep_ref(*_t(A, b, inv_rip, f0), beta=beta, iters=2)
    for s in range(4):
        ja = [jnp.asarray(x) for x in (A, b[s], inv_rip, f0[s])]
        pallas = jart_kernel.art_sweep(*ja, beta=beta, iters=2,
                                       interpret=True)
        ref = jart_ref.art_sweep_ref(*ja, beta=beta, iters=2)
        for want in (pallas, ref):
            np.testing.assert_allclose(got[s].numpy(), np.asarray(want),
                                       **TOL)


def test_torch_art_converges_consistent_system():
    """Kaczmarz converges on a consistent overdetermined system
    (tests/test_kernels.py:111-120), through the port's dispatch."""
    A, b, _ = _system(_rng("art-converge"), 64, 16, 1)
    f_true = np.linalg.lstsq(A.astype(np.float64), b[0].astype(np.float64),
                             rcond=None)[0]
    A_t, b_t = _t(A, b)
    f = tart_ops.art_reconstruct(A_t, b_t, torch.zeros((1, 16)), beta=1.0,
                                 iters=30)
    np.testing.assert_allclose(f[0].numpy(), f_true, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_torch_art_reconstruct_matches_jax_with_an_empty_row(use_pallas):
    """``inv_rip`` as ``repro/kernels/art/ops.py:19-20`` computes it: an
    empty row gets 0 and leaves the image alone."""
    rng = _rng("art-empty")
    A, b, _ = _system(rng, 12, 8, 2)
    A[5] = 0.0
    f0 = rng.standard_normal((2, 8)).astype(np.float32)
    got = tart_ops.art_reconstruct(*_t(A, b, f0), beta=0.8, iters=2)
    inv = tart_ops.inverse_row_norms(torch.from_numpy(A))
    assert inv[5] == 0 and torch.all(inv[torch.arange(12) != 5] > 0)
    for s in range(2):
        want = jart_ops.art_reconstruct_slice(
            jnp.asarray(A), jnp.asarray(b[s]), jnp.asarray(f0[s]), beta=0.8,
            iters=2, use_pallas=use_pallas)
        np.testing.assert_allclose(got[s].numpy(), np.asarray(want), **TOL)


# -- the system as CSR, and the kernel's sweep over it --------------------------
def _dense(csr):
    """The dense matrix a CSR stands for, rebuilt entry by entry."""
    nrow, ncol = csr.shape
    rp = csr.row_ptr.numpy()
    A = np.zeros((nrow, ncol), np.float32)
    for j in range(nrow):
        A[j, csr.col[rp[j]:rp[j + 1]].numpy()] = csr.val[rp[j]:rp[j + 1]]
    return A


def _ray_system(nray, nangles):
    return tproj.parallel_ray_matrix(nray, _angles(nangles))


@pytest.mark.parametrize("nangles", [9, 19])
def test_torch_csr_rows_round_trips_the_ray_system(nangles):
    A = _ray_system(16, nangles)
    csr = tart_ops.csr_rows(torch.from_numpy(A))
    assert csr.shape == A.shape
    assert csr.row_ptr.dtype == torch.int64 and csr.col.dtype == torch.int32
    assert csr.val.dtype == torch.float32
    assert int(csr.row_ptr[-1]) == csr.col.numel() == np.count_nonzero(A)
    assert bool((csr.val != 0).all())
    rp = csr.row_ptr.numpy()
    for j in range(A.shape[0]):        # columns ascending within each row
        assert np.all(np.diff(csr.col[rp[j]:rp[j + 1]].numpy()) > 0)
    np.testing.assert_array_equal(_dense(csr), A)


def test_torch_csr_rows_keeps_an_empty_row():
    A, _, _ = _system(_rng("csr-empty"), 12, 8, 1)
    A[5] = 0.0
    A[0, ::2] = 0.0
    csr = tart_ops.csr_rows(torch.from_numpy(A))
    assert int(csr.row_ptr[5]) == int(csr.row_ptr[6])
    np.testing.assert_array_equal(_dense(csr), A)
    with pytest.raises(ValueError, match="float32"):
        tart_ops.csr_rows(torch.from_numpy(A).double())


def _csr_sweep_model(csr, b, inv_rip, f0, beta, iters):
    """The CUDA kernel's arithmetic, one slice a warp of 32 lanes: for each
    row in order, lane l sums val * f over the row's non-zeros l, l + 32,
    ... with fused multiply-adds (exact products, one rounding), a butterfly
    shuffle sum combines the lanes, c = beta * ((b_j - dot) * inv_rip_j)
    and f[col] = f[col] + c * val, each op rounded to fp32."""
    f32 = np.float32
    rp, col, val = (x.numpy() for x in (csr.row_ptr, csr.col, csr.val))
    f = f0.copy()
    for s in range(f.shape[0]):
        fs = f[s]
        for _ in range(iters):
            for j in range(len(rp) - 1):
                cj, vj = col[rp[j]:rp[j + 1]], val[rp[j]:rp[j + 1]]
                part = np.zeros(32, f32)
                for k in range(len(cj)):
                    lane = k % 32
                    part[lane] = f32(np.float64(vj[k]) * np.float64(fs[cj[k]])
                                     + np.float64(part[lane]))
                for off in (16, 8, 4, 2, 1):
                    part = part + part[np.arange(32) ^ off]
                c = f32(beta) * ((f32(b[s, j]) - part[0]) * f32(inv_rip[j]))
                fs[cj] = fs[cj] + c * vj
    return f


@pytest.mark.parametrize("case", ["ray-16x9", "dense-32x64", "dense-20x12"])
@pytest.mark.parametrize("iters", [1, 3])
def test_torch_csr_sweep_model_matches_jax(case, iters):
    """The kernel's order of operations over the non-zeros gives the JAX
    dense sweep (``art_sweep_ref``) and the Pallas kernel in interpret mode
    at 1e-4: skipping zeros changes no update, only the dot's order."""
    rng = _rng("csr-sweep", case, iters)
    if case.startswith("ray"):
        A = _ray_system(16, 9)
        vol = rng.standard_normal((1, A.shape[1])).astype(np.float32)
        b = (vol @ A.T).astype(np.float32)
        inv_rip = tart_ops.inverse_row_norms(torch.from_numpy(A)).numpy()
    else:
        nrow, ncol = (int(x) for x in case.split("-")[1].split("x"))
        A, b, inv_rip = _system(rng, nrow, ncol, 1)
    f0 = np.zeros((1, A.shape[1]), np.float32)
    got = _csr_sweep_model(tart_ops.csr_rows(torch.from_numpy(A)), b,
                           inv_rip, f0, 1.0, iters)
    ja = [jnp.asarray(x) for x in (A, b[0], inv_rip, f0[0])]
    pallas = jart_kernel.art_sweep(*ja, beta=1.0, iters=iters,
                                   interpret=True)
    ref = jart_ref.art_sweep_ref(*ja, beta=1.0, iters=iters)
    for want in (pallas, ref):
        np.testing.assert_allclose(got[0], np.asarray(want), **TOL)


# -- projector and phantom ----------------------------------------------------
@pytest.mark.parametrize("nray", [16, 32])
def test_torch_parallel_ray_matrix_equals_reference(nray):
    angles = _angles(9)
    got = tproj.make_system(nray, np.asarray(angles))
    want = jproj.make_system(nray, np.asarray(angles))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_torch_project_matches_numpy():
    A = tproj.make_system(16, np.asarray(_angles(9)))
    vol = _rng("project").standard_normal((3, 16, 16)).astype(np.float32)
    got = tproj.project(torch.from_numpy(A), torch.from_numpy(vol))
    np.testing.assert_allclose(got.numpy(), jproj.project(A, vol),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nslice,nray,seed", [(6, 16, 0), (5, 32, 3)])
def test_torch_make_phantom_equals_reference(nslice, nray, seed):
    np.testing.assert_array_equal(
        tsolver.make_phantom(nslice, nray, seed),
        jsolver.make_phantom(nslice, nray, seed))


def test_torch_simulate_tilt_series_matches_reference():
    cfg = tsolver.TomoConfig(nray=16, angles=_angles(9))
    vol, sino, sino_host = tsolver.simulate_tilt_series(cfg, 4,
                                                        device="cpu")
    jvol, jsino = jsolver.simulate_tilt_series(
        jsolver.TomoConfig(nray=16, angles=_angles(9)), 4)
    np.testing.assert_array_equal(vol.numpy(), jvol)
    np.testing.assert_allclose(sino.numpy(), jsino, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(sino_host, sino.numpy())


# -- the slice solver ---------------------------------------------------------
@pytest.mark.parametrize("use_pallas", [False, True])
def test_torch_reconstruct_slices_matches_jax(use_pallas):
    jcfg = jsolver.TomoConfig(nray=16, angles=_angles(9), iterations=2,
                              use_pallas=use_pallas)
    _, sino = jsolver.simulate_tilt_series(jcfg, 3)
    cfg = tsolver.TomoConfig(nray=16, angles=_angles(9), iterations=2)
    got = tsolver.reconstruct_slices(torch.from_numpy(sino), cfg)
    want = jsolver.reconstruct_slices(sino, jcfg)
    assert got.shape == want.shape == (3, 16, 16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_torch_reconstruct_slices_asked_for_the_kernel_does_not_fall_back():
    """The solver's cached system, handed to the sweep with the kernel asked
    for, raises on a CPU block instead of running the plain sweep, and
    nothing counts as launched."""
    from repro_torch import kernels
    cfg = tsolver.TomoConfig(nray=16, angles=_angles(9))
    A, inv_rip, csr = tsolver.system_on_device(cfg, "cpu")
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        tart_ops.art_reconstruct(A, torch.zeros((2, A.shape[0])),
                                 torch.zeros((2, A.shape[1])), beta=1.0,
                                 iters=2, use_kernel=True, inv_rip=inv_rip,
                                 csr=csr)
    assert kernels.launch_counts()["art_sweep"] == 0


def test_torch_reconstruct_partition_on_the_cpu_enters_no_stream(
        monkeypatch):
    """On the CPU a partition runs as it always has: its slice indices, and
    the sweep of its rows as one block, bit for bit and as the reference
    computes it; no CUDA stream is taken or entered, and
    ``art_own_stream_calls_total`` stays at 0."""
    from repro_torch.apps.tomo.stream import reconstruct_partition
    from repro_torch.data import metrics as M
    cfg = tsolver.TomoConfig(nray=16, angles=_angles(9), iterations=2)
    _, _, sino = tsolver.simulate_tilt_series(cfg, 5, device="cpu")
    rows = [1, 2, 4]
    streams = []
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda *a, **kw: streams.append(("Stream", a)))
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda *a, **kw: streams.append(("stream", a)))
    reg = M.MetricsRegistry()
    prev = M.set_registry(reg)
    try:
        idx, block = reconstruct_partition([(i, sino[i]) for i in rows], cfg,
                                           "cpu")
    finally:
        M.set_registry(prev)
    assert idx == rows
    want = tsolver.reconstruct_slices(torch.from_numpy(sino[rows]), cfg)
    assert block.dtype == np.float32 and block.shape == (3, 16, 16)
    np.testing.assert_array_equal(block, want.numpy())
    jcfg = jsolver.TomoConfig(nray=16, angles=_angles(9), iterations=2,
                              use_pallas=False)
    np.testing.assert_allclose(block, jsolver.reconstruct_slices(
        sino[rows], jcfg), **TOL)
    assert streams == []
    assert reg.counter("art_own_stream_calls_total").value() == 0


class _Event:
    """A CUDA event's ``query``: whether the work before it has finished."""

    def __init__(self, done: bool) -> None:
        self.done = done

    def query(self) -> bool:
        return self.done


def test_torch_art_in_flight_counts_other_threads_unfinished_sweeps():
    """``in_flight``: the sweeps other threads enqueued whose end event has
    not passed; the finished ones leave the list, the caller's own do not
    count."""
    pending = [(1, _Event(False)), (2, _Event(True)), (3, _Event(False)),
               (1, _Event(True)), (2, _Event(False))]
    assert tart_ops._in_flight(pending, 1) == 2
    assert [t for t, _ in pending] == [1, 3, 2]
    assert tart_ops._in_flight(pending, 4) == 3
    pending[1][1].done = True
    assert tart_ops._in_flight(pending, 2) == 1
    assert [t for t, _ in pending] == [1, 2]
    for _, ev in pending:
        ev.done = True
    assert tart_ops._in_flight(pending, 1) == 0 and pending == []


@pytest.mark.parametrize("use_pallas", [False, True])
def test_torch_tomo_reduces_residual_as_reference(use_pallas):
    """tests/test_apps.py:77-85 on the port: the same residual and volume
    error as the reference, both below the limits there."""
    angles = _angles(19)
    jcfg = jsolver.TomoConfig(nray=32, angles=angles, iterations=3,
                              use_pallas=use_pallas)
    jvol, jsino = jsolver.simulate_tilt_series(jcfg, nslice=6)
    jrec = jsolver.reconstruct_slices(jsino, jcfg)
    cfg = tsolver.TomoConfig(nray=32, angles=angles, iterations=3)
    vol, sino, _ = tsolver.simulate_tilt_series(cfg, 6, device="cpu")
    rec = tsolver.reconstruct_slices(sino, cfg)
    r = tsolver.residual(rec, sino, cfg)
    err = float(torch.linalg.vector_norm(rec - vol)
                / torch.linalg.vector_norm(vol))
    jr = jsolver.residual(jrec, jsino, jcfg)
    jerr = float(np.linalg.norm(jrec - jvol) / np.linalg.norm(jvol))
    assert r < 0.3 and err < 0.6, (r, err)
    assert abs(r - jr) < 1e-4 and abs(err - jerr) < 1e-4, (r, jr, err, jerr)
    per_slice = tsolver.residual(rec, sino, cfg, per_slice=True)
    assert per_slice.shape == (6,) and np.all(per_slice < 1.0)


# -- the entry point ----------------------------------------------------------
SMALL = ["--nray", "16", "--angles", "9", "--nslice", "12", "--iterations",
         "2", "--partitions", "2"]


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("tomo")
    args = parse_args(SMALL + ["--out", str(out)])
    return args, run_stream(args, device="cpu")


def test_torch_tomo_stream_volume_matches_jax(small_run):
    args, res = small_run
    jcfg = jsolver.TomoConfig(nray=16, angles=_angles(9), iterations=2,
                              use_pallas=False)
    jvol, jsino = jsolver.simulate_tilt_series(jcfg, 12)
    want = jsolver.reconstruct_slices(jsino, jcfg)
    np.testing.assert_allclose(res["volume"], want, **TOL)
    jerr = np.linalg.norm(want - jvol) / np.linalg.norm(jvol)
    assert abs(res["residual"] - jsolver.residual(want, jsino, jcfg)) < 1e-4
    assert abs(res["error"] - jerr) < 1e-4
    assert res["slice_residuals"].shape == res["slice_errors"].shape == (12,)


def test_torch_tomo_stream_keys_and_counts(small_run):
    """Batches of nslice/partitions slices, each re-cut into partitions of
    neighbouring slices keyed ``slices-%04d-%04d``; on the CPU the plain
    sweep runs and no kernel launches."""
    args, res = small_run
    assert res["report"].records == 12
    assert res["report"].batches == len(res["batch_times"]) == 2
    assert res["partitions"] == 4
    assert res["launches"] == 0
    assert res["sink_keys"] == ["slices-0000-0002", "slices-0003-0005",
                                "slices-0006-0008", "slices-0009-0011"]
    assert res["matrix_build_time"] >= 0 and res["matrix_copy_time"] >= 0
    assert res["setup_time"] >= res["matrix_build_time"]


def test_torch_tomo_stream_rerun_adds_no_file(small_run):
    args, res = small_run
    sink_dir = f"{args.out}/tomo_subvolumes_12x16x9x2"
    sink = NpzDirectorySink(sink_dir)
    with np.load(sink.path_for("slices-0003-0005")) as z:
        np.testing.assert_array_equal(z["idx"], [3, 4, 5])
        assert z["block"].shape == (3, 16, 16)
    before = sorted(p.name for p in pathlib.Path(args.out).rglob("*"))
    again = run_stream(args, device="cpu")
    after = sorted(p.name for p in pathlib.Path(args.out).rglob("*"))
    assert after == before
    assert again["sink_keys"] == res["sink_keys"]
    np.testing.assert_allclose(again["volume"], res["volume"], rtol=1e-6,
                               atol=1e-6)


# -- host pieces --------------------------------------------------------------
def test_torch_projection_source_matches_reference():
    sino = _rng("source").standard_normal((7, 5)).astype(np.float32)
    got, want = ProjectionSource(sino), jsources.ProjectionSource(sino)
    assert len(got) == len(want) == 7
    for polled in ((got.poll(3), want.poll(3)), (got.poll(10),
                                                 want.poll(10))):
        assert [k for k, _ in polled[0]] == [k for k, _ in polled[1]]
        for (_, (i, row)), (_, (j, jrow)) in zip(*polled):
            assert i == j
            np.testing.assert_array_equal(row, jrow)
    assert got.exhausted and want.exhausted
    got.seek(2)
    want.seek(2)
    assert got.poll(1)[0][0] == want.poll(1)[0][0] == b"slice-000002"


@pytest.mark.parametrize("n,parts", [(10, 4), (3, 3), (7, 1), (2, 5)])
def test_torch_parallelize_map_partitions_match_reference(n, parts):
    items = [(i, i * i) for i in range(n)]
    got = Context().parallelize(items, parts)
    want = jrdd.Context(num_executors=1).parallelize(items, parts)
    assert got.collect_partitions() == want.collect_partitions()

    def summed(part):
        return [sum(v for _, v in part)]

    assert (got.map_partitions(summed).collect()
            == want.map_partitions(summed).collect())
    with pytest.raises(ValueError):
        Context().parallelize(items, 0)
