"""The port's PMI wire-up on the CPU: the counterparts of tests/test_pmi.py
(put/fence/get, the threaded rank wire-up, generations with dense
re-ranking, the heartbeat watchdog), and one membership script run on both
packages' servers, whose ranks and generations must agree."""
import threading
import time

import pytest

from repro.core import pmi as jax_pmi
from repro_torch.core import pmi as torch_pmi
from repro_torch.core.fault import Watchdog
from repro_torch.core.pmi import KeyValueSpace, PMIClient, PMIError, PMIServer


def test_torch_kvs_get_before_fence_raises():
    kvs = KeyValueSpace()
    kvs.put(0, "addr/0", "a:1")
    with pytest.raises(PMIError):
        kvs.get("addr/0")
    assert kvs.get("addr/0", None) is None
    kvs.commit_all()
    assert kvs.get("addr/0") == "a:1"
    assert kvs.fence_count == 1
    assert kvs.snapshot() == {"addr/0": "a:1"}


def test_torch_threaded_wireup_fence():
    """The paper's rank wire-up: every worker puts its endpoint, fences,
    then reads every other endpoint, race-free by the fence contract."""
    server = PMIServer(world_size=4)
    clients = [PMIClient(server, f"w{i}") for i in range(4)]
    results: dict[int, list[str]] = {}

    def worker(c: PMIClient):
        c.put(f"addr/{c.rank}", f"host{c.rank}:94{c.rank}0")
        c.fence(timeout=5)
        results[c.rank] = [c.get(f"addr/{r}") for r in range(4)]

    threads = [threading.Thread(target=worker, args=(c,)) for c in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 4
    for r in range(4):
        assert results[r] == [f"host{i}:94{i}0" for i in range(4)]


def test_torch_generation_bump_on_failure():
    server = PMIServer(world_size=3)
    clients = [PMIClient(server, f"w{i}") for i in range(3)]
    assert [c.rank for c in clients] == [0, 1, 2]
    gen = server.fail_worker("w1")
    assert gen == 1
    alive = server.alive_workers()
    assert [w.worker_id for w in alive] == ["w0", "w2"]
    assert [w.rank for w in alive] == [0, 1]       # dense re-rank
    with pytest.raises(PMIError):
        server.heartbeat("w1")                     # the dead cannot beat


def test_torch_watchdog_detects_stale_heartbeat():
    server = PMIServer(world_size=2, heartbeat_timeout=0.2)
    PMIClient(server, "w0")
    PMIClient(server, "w1")
    failures: list[list[str]] = []
    dog = Watchdog(server, interval=0.05, on_failure=failures.append)
    dog.start()
    t_end = time.monotonic() + 1.0
    while time.monotonic() < t_end and not failures:
        server.heartbeat("w0")      # only w0 stays alive
        time.sleep(0.05)
    dog.stop()
    assert not dog._thread.is_alive()
    assert failures and failures[0] == ["w1"]
    assert server.generation == 1


def test_torch_fence_raises_when_a_worker_dies_mid_fence():
    """A fence waiting on a worker that dies fails at once with the
    generation change, not at its timeout."""
    server = PMIServer(world_size=2)
    a, _ = PMIClient(server, "w0"), PMIClient(server, "w1")
    errors: list[Exception] = []

    def fence():
        try:
            a.fence(timeout=10)
        except PMIError as exc:
            errors.append(exc)

    t = threading.Thread(target=fence)
    t0 = time.monotonic()
    t.start()
    time.sleep(0.1)
    server.fail_worker("w1")
    t.join(timeout=5)
    assert not t.is_alive()
    assert time.monotonic() - t0 < 5
    assert len(errors) == 1 and "generation changed" in str(errors[0])


def _membership_script(mod):
    """Register, fail, re-register and expire workers on ``mod``'s server;
    returns every observable step."""
    server = mod.PMIServer(world_size=4, heartbeat_timeout=3600.0)
    trace = []
    clients = [mod.PMIClient(server, f"w{i}", meta={"i": i})
               for i in range(4)]
    trace.append([(c.rank, c.generation) for c in clients])
    for c in clients:
        c.put(f"coords/{c.rank}", f"dev{c.rank}")
    server.kvs().commit_all()
    trace.append(sorted(server.kvs().snapshot().items()))
    trace.append(server.fail_worker("w2"))
    trace.append([(w.worker_id, w.rank, w.generation)
                  for w in server.alive_workers()])
    late = mod.PMIClient(server, "w4")
    trace.append((late.rank, late.generation))
    trace.append(server.fail_worker("w0"))
    trace.append([(w.worker_id, w.rank, w.generation)
                  for w in server.alive_workers()])
    # a re-registering live worker keeps its info
    trace.append(server.register("w1").rank)
    trace.append(server.check_heartbeats())
    trace.append(sorted(server.kvs(0).snapshot().items()))
    trace.append(server.kvs().snapshot())
    return trace


def test_torch_pmi_membership_matches_reference():
    assert _membership_script(torch_pmi) == _membership_script(jax_pmi)
