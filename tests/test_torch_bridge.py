"""The port's Spark<->MPI bridge on the CPU, held to the JAX package's
``MPIBridge`` on the same numpy inputs: the counterparts of
tests/test_multidevice.py's bridge tests on 8 spawned gloo ranks (sum, max
and mean against numpy and the reference, rtol 1e-5 and atol 1e-4; int8
within 0.05 of the exact sum and within one quantisation step of the
reference's ``compressed_psum`` over 8 virtual devices; the ring shift
through ``run`` with point-to-point sends; ``driver_reduce``; ``to_rdd``;
the PMI coordinates); the same reductions over 8 local ranks in one
process; one §III ``raar_step`` chain over 4 gloo ranks with ``group=``,
held to the one-process chain (1e-5 relative, L2) and to the reference's
``raar_step(axis_name=...)`` under ``shard_map`` over 4 virtual devices
(2e-4, tests/test_apps.py's tolerance); and the quickstart entry point at a
small N.

The reference runs in one subprocess with 8 virtual devices, as
tests/test_multidevice.py runs it; the ranks are spawned once a fixture,
and a rank that hangs fails its test at the fixture's time limit.
"""
import multiprocessing as mp
import os
import queue
import subprocess
import sys
import textwrap
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.apps.quickstart import make_payload, run_quickstart
from repro_torch.core.bridge import TorchBridge, rank_of, world_of
from repro_torch.core.rdd import Context

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
WORLD, RAAR_WORLD, RAAR_STEPS = 8, 4, 3
OBJ, PROBE, STEP = 48, 16, 6              # 36 frames, 9 a rank at world 4
TOL = dict(rtol=1e-5, atol=1e-4)          # tests/test_multidevice.py:44
SPAWN_TIMEOUT = 120.0
GROUP_REL = 1e-5


def _parts(seed: int, n: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(WORLD)]


# -- the reference, on 8 virtual devices ---------------------------------------

_REFERENCE = """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.apps.ptycho import sim, solver
    from repro.core import Context, MPIBridge
    from repro.utils import make_mesh_compat, shard_map_compat

    def parts(seed, n):
        rng = np.random.default_rng(seed)
        return [rng.standard_normal(n).astype(np.float32) for _ in range(8)]

    ctx = Context()
    bridge = MPIBridge()
    assert bridge.world == 8
    out = {{}}
    for op in ("sum", "max", "mean"):
        out[op] = bridge.allreduce(ctx.from_partitions(parts(0, 1000)), op)
    out["int8"] = bridge.allreduce(ctx.from_partitions(parts(1, 4096)),
                                   compression="int8")
    ring = [np.full((4,), float(r), np.float32) for r in range(8)]
    out["ring"] = np.asarray(bridge.run(ctx.from_partitions(ring), lambda x:
        jax.lax.ppermute(x, "workers", [(i, (i + 1) % 8) for i in range(8)])))

    prob = sim.simulate({obj}, {probe}, {step})
    psi0 = solver.init_waves(prob.magnitudes, prob.probe_true)
    cfg = solver.SolverConfig(use_pallas=False)
    mesh = make_mesh_compat(({raar_world},), ("workers",),
                            devices=jax.devices()[:{raar_world}])

    def chain(psi, mag, pos, probe):
        for it in range({steps}):
            psi, obj, probe, err = solver.raar_step(
                psi, mag, pos, probe, ({obj}, {obj}), cfg, it,
                axis_name="workers")
        return psi, obj, probe, err

    w = P("workers")
    program = jax.jit(shard_map_compat(chain, mesh=mesh,
                                       in_specs=(w, w, w, P()),
                                       out_specs=(w, P(), P(), P())))
    shard = NamedSharding(mesh, w)
    res = program(jax.device_put(psi0, shard),
                  jax.device_put(prob.magnitudes, shard),
                  jax.device_put(jnp.asarray(prob.positions), shard),
                  prob.probe_true)
    for k, v in zip(("psi", "obj", "probe", "err"), res):
        out["raar_" + k] = v
    out.update(raar_psi0=psi0, raar_mag=prob.magnitudes,
               raar_pos=prob.positions, raar_probe0=prob.probe_true)
    np.savez({path!r}, **{{k: np.asarray(v) for k, v in out.items()}})
    print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bridge_ref") / "ref.npz")
    code = textwrap.dedent(_REFERENCE).format(
        src=os.path.join(ROOT, "src"), path=path, obj=OBJ, probe=PROBE,
        step=STEP, raar_world=RAAR_WORLD, steps=RAAR_STEPS)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# -- spawned gloo ranks ---------------------------------------------------------

def _rank_main(fn, rank, world, init, args, results):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        results.put((rank, None, fn(rank, world, *args)))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world, args, tmpdir, timeout=SPAWN_TIMEOUT):
    """``fn(rank, world, *args)`` on ``world`` spawned gloo ranks; returns
    each rank's result in rank order. A rank that raises, dies or outlives
    ``timeout`` fails the caller, and every rank is killed."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = f"file://{os.path.join(str(tmpdir), 'store')}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, init, args, results),
                         daemon=True) for r in range(world)]
    got: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                pytest.fail(f"ranks {sorted(set(range(world)) - set(got))} "
                            f"gave no result within {timeout} s")
            try:
                rank, err, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got}
                if dead:
                    pytest.fail(f"ranks died with exit codes {dead}")
                continue
            if err is not None:
                pytest.fail(f"rank {rank} raised:\n{err}")
            got[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        assert [p.exitcode for p in procs] == [0] * world
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    return [got[r] for r in range(world)]


def _ring_shift(x):
    """Every rank sends its block to the next and receives the previous
    one's: MPI_Sendrecv, on ``torch.distributed``'s point-to-point ops."""
    r, n = rank_of(dist.group.WORLD), world_of(dist.group.WORLD)
    out = torch.empty_like(x)
    for req in (dist.isend(x, (r + 1) % n), dist.irecv(out, (r - 1) % n)):
        req.wait()
    return out


def _bridge_rank(rank, world):
    ctx = Context()
    bridge = TorchBridge(device="cpu", group=dist.group.WORLD)
    rdd = ctx.from_partitions(_parts(0, 1000))
    out = {op: bridge.allreduce(rdd, op).numpy()
           for op in ("sum", "max", "mean")}
    out["int8"] = bridge.allreduce(ctx.from_partitions(_parts(1, 4096)),
                                   compression="int8").numpy()
    out["driver"] = TorchBridge.driver_reduce(rdd)
    ring = [np.full((4,), float(r), np.float32) for r in range(world)]
    shifted = bridge.run(ctx.from_partitions(ring), _ring_shift)
    out["ring"] = shifted.numpy()
    back = bridge.to_rdd(ctx, shifted)
    out["to_rdd"] = back.collect_partitions()
    out["world"] = (bridge.world, bridge.local_world, bridge.group_world,
                    list(bridge.ranks))
    out["coords"] = bridge.pmi.kvs().snapshot()
    out["quickstart"] = run_quickstart(1000, bridge=bridge)["mpi"].numpy()
    try:
        bridge.allreduce(ctx.from_partitions(ring[:3]))
    except ValueError as exc:
        out["repartition"] = str(exc)
    return out


@pytest.fixture(scope="module")
def gloo8(tmp_path_factory):
    return spawn_ranks(_bridge_rank, WORLD, (),
                       tmp_path_factory.mktemp("gloo8"))


def test_torch_bridge_allreduce_matches_numpy(gloo8, ref):
    parts = _parts(0, 1000)
    want = {"sum": np.sum(parts, axis=0), "max": np.max(parts, axis=0),
            "mean": np.mean(parts, axis=0)}
    for out in gloo8:
        for op, w in want.items():
            np.testing.assert_allclose(out[op], w, **TOL)
            np.testing.assert_allclose(out[op], ref[op], **TOL)
        np.testing.assert_array_equal(out["sum"], gloo8[0]["sum"])
        np.testing.assert_allclose(out["driver"], want["sum"], **TOL)


def test_torch_bridge_compressed_allreduce_error_bounded(gloo8, ref):
    parts = _parts(1, 4096)
    exact = np.sum(parts, axis=0)
    step = np.max(np.abs(parts)) / 127.0      # one step of the shared grid
    for out in gloo8:
        got = out["int8"]
        rel = np.linalg.norm(got - exact) / np.linalg.norm(exact)
        assert rel < 0.05, rel
        assert np.max(np.abs(got - ref["int8"])) <= step * (1 + 1e-6)


def test_torch_bridge_rank_parallel_program(gloo8, ref):
    """An MPI-style program through ``run``: each rank sends its block to
    the next; rank r ends with r - 1's, as the reference's ppermute."""
    for r, out in enumerate(gloo8):
        assert out["ring"].shape == (1, 4)
        np.testing.assert_array_equal(out["ring"][0], ref["ring"][r])
        np.testing.assert_array_equal(out["ring"][0],
                                      np.full(4, (r - 1) % WORLD))
        (part,) = out["to_rdd"]
        np.testing.assert_array_equal(part, out["ring"][0])


def test_torch_bridge_ranks_and_pmi_wireup(gloo8):
    for r, out in enumerate(gloo8):
        assert out["world"] == (WORLD, 1, WORLD, [r])
        assert out["coords"] == {f"coords/{i}": "cpu" for i in range(WORLD)}
        assert "3 partitions but bridge world is 8" in out["repartition"]


def test_torch_quickstart_over_gloo_ranks(gloo8):
    want = make_payload(1000) * WORLD
    for out in gloo8:
        np.testing.assert_allclose(out["quickstart"], want, **TOL)
        assert out["quickstart"][-1] == 5.0 * WORLD


# -- local ranks in one process -------------------------------------------------

def test_torch_bridge_local_ranks_match_numpy(ref):
    """8 local ranks in one process: the same reductions, no process
    group; a collective program needs one process a rank."""
    ctx = Context()
    bridge = TorchBridge(devices=[CPU] * WORLD)
    assert (bridge.world, bridge.group) == (WORLD, None)
    parts = _parts(0, 1000)
    rdd = ctx.from_partitions(parts)
    for op, want in (("sum", np.sum(parts, 0)), ("max", np.max(parts, 0)),
                     ("mean", np.mean(parts, 0))):
        got = bridge.allreduce(rdd, op)
        assert got.device == CPU
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got.numpy(), ref[op], **TOL)
    np.testing.assert_array_equal(parts[0], rdd.compute_partition(0))
    int8 = bridge.allreduce(ctx.from_partitions(_parts(1, 4096)),
                            compression="int8").numpy()
    step = np.max(np.abs(_parts(1, 4096))) / 127.0
    assert np.max(np.abs(int8 - ref["int8"])) <= step * (1 + 1e-6)
    np.testing.assert_allclose(TorchBridge.driver_reduce(rdd),
                               np.sum(parts, 0), **TOL)
    tree = bridge.allreduce(ctx.from_partitions(
        [{"a": p, "b": [p[:3]]} for p in parts]))
    np.testing.assert_allclose(tree["b"][0].numpy(), np.sum(parts, 0)[:3],
                               **TOL)
    stacked = torch.from_numpy(np.stack(parts))
    back = bridge.to_rdd(ctx, {"x": stacked})
    assert back.num_partitions == WORLD
    np.testing.assert_array_equal(back.compute_partition(3)["x"], parts[3])
    with pytest.raises(ValueError, match="one process a rank"):
        bridge.run(rdd, lambda x: x)
    with pytest.raises(ValueError, match="local ranks"):
        bridge.to_rdd(ctx, stacked[:2])
    with pytest.raises(ValueError, match="unknown op"):
        bridge.allreduce(rdd, "min")
    with pytest.raises(ValueError, match="driver_reduce"):
        TorchBridge.driver_reduce(rdd, "max")


def test_torch_bridge_defaults_to_cuda():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchBridge()


def test_torch_quickstart_small_n(capsys):
    res = run_quickstart(1000, device="cpu")
    assert res["world"] == 1
    np.testing.assert_array_equal(res["driver"], make_payload(1000))
    np.testing.assert_array_equal(res["mpi"].numpy(), make_payload(1000))
    res = run_quickstart(1000, bridge=TorchBridge(devices=[CPU] * 3))
    assert res["mpi"][-1] == 15.0 and res["driver"][-1] == 15.0
    out = capsys.readouterr().out
    assert "spark-mpi   : buffer[-1] = 15.0" in out


# -- the §III step over a process group ----------------------------------------

def _raar_rank(rank, world, inputs):
    """A chain of RAAR steps on this rank's quarter of the frames, its
    partial sums all-reduced over the group."""
    # imported here: the solver's simulator pulls in scipy, which the
    # other ranks' programs do not need
    from repro_torch.apps.ptycho.solver import SolverConfig, raar_step
    bridge = TorchBridge(device="cpu", group=dist.group.WORLD)
    lo, hi = (rank * len(inputs["raar_pos"]) // world,
              (rank + 1) * len(inputs["raar_pos"]) // world)
    psi = torch.from_numpy(inputs["raar_psi0"][lo:hi])
    mag = torch.from_numpy(inputs["raar_mag"][lo:hi])
    probe = torch.from_numpy(inputs["raar_probe0"])
    for it in range(RAAR_STEPS):
        psi, obj, probe, err = raar_step(
            psi, mag, inputs["raar_pos"][lo:hi], probe, (OBJ, OBJ),
            SolverConfig(), it, group=bridge.group)
    return {"psi": psi.numpy(), "obj": obj.numpy(), "probe": probe.numpy(),
            "err": err.numpy()}


@pytest.fixture(scope="module")
def gloo_raar(ref, tmp_path_factory):
    inputs = {k: v for k, v in ref.items() if k.startswith("raar_")
              and k[5:] in ("psi0", "mag", "pos", "probe0")}
    return spawn_ranks(_raar_rank, RAAR_WORLD, (inputs,),
                       tmp_path_factory.mktemp("gloo_raar"))


def test_torch_raar_step_over_a_group_matches_one_process_and_jax(
        gloo_raar, ref):
    from repro_torch.apps.ptycho.solver import SolverConfig, raar_step
    psi = torch.from_numpy(ref["raar_psi0"])
    probe = torch.from_numpy(ref["raar_probe0"])
    mag = torch.from_numpy(ref["raar_mag"])
    for it in range(RAAR_STEPS):
        psi, obj, probe, err = raar_step(psi, mag, ref["raar_pos"], probe,
                                         (OBJ, OBJ), SolverConfig(), it)
    one = {"psi": psi.numpy(), "obj": obj.numpy(), "probe": probe.numpy(),
           "err": err.numpy()}
    got = {"psi": np.concatenate([r["psi"] for r in gloo_raar])}
    for k in ("obj", "probe", "err"):
        for r in gloo_raar[1:]:               # the sums agree on every rank
            np.testing.assert_array_equal(r[k], gloo_raar[0][k])
        got[k] = gloo_raar[0][k]
    for k, v in got.items():
        # the split only reorders float32 sums: |a - b| / |b| (L2) within
        # GROUP_REL, the bound chip_smoke.py's phase 16 holds on the card
        rel = np.linalg.norm(v - one[k]) / np.linalg.norm(one[k])
        assert rel <= GROUP_REL, (k, rel)
        np.testing.assert_allclose(v, ref["raar_" + k], rtol=2e-4, atol=2e-4)
