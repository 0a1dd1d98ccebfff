"""The port's consumer groups on the CPU: the counterparts of
tests/test_groups.py — rebalance, failover, and the partition-handoff chaos
suite — and the same protocol held to the reference's.

The contract under test, layer by layer:

- ``sticky_assign`` — every partition exactly once, balance within one,
  sticky under unchanged membership (a seeded sweep and a hypothesis
  property suite), and equal to the reference's assignor on seeded
  membership sequences.
- ``GroupCoordinator`` — two-phase join/sync, heartbeat-lease liveness with
  *lazy* expiry (survivors' calls evict the dead — no background thread),
  generation fencing of commits (stale generation, unowned partition,
  evicted member), all with an injected fake clock; the same join, leave
  and expiry script gives the reference's generations and assignments.
- ``StreamingContext`` group mode — two contexts split a topic's partitions
  and, once the assignment settles, consume strictly disjoint slices whose
  union is the whole topic; group commits never touch the default group.
- ``GroupConsumer`` — per-partition window-state handoff: a graceful leave
  migrates the *open* window to the next owner, which replays it and fires
  the exact window set a never-rebalanced run fires.
- The chaos test: three consumer processes over the socket transport, one
  SIGKILLed mid-window; the survivors detect the eviction, take over the
  dead member's partition, replay its open window from the handoff
  checkpoint, and the merged output equals an uncrashed run's — with the
  group's lag signal drained to zero.

Every test runs with the port's lock tracing on and asserts afterwards that
the locks it took were acquired in no cyclic order. The reference is
imported inside the tests that use it, so the spawned consumer processes of
the chaos test import the port alone.
"""
import json
import multiprocessing as mp
import os
import random
import signal
import threading
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core.broker import Broker
from repro_torch.core.dstream import StreamingContext
from repro_torch.core.rdd import Context
from repro_torch.data import locktrace
from repro_torch.data.groups import (GroupConsumer, GroupCoordinator,
                                     GroupError, GroupMember,
                                     StaleGenerationError, sticky_assign)
from repro_torch.data.metrics import MetricsRegistry, set_registry
from repro_torch.data.transport import RemoteBroker, serve_broker
from repro_torch.data.window import WindowSpec


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


@pytest.fixture
def fresh_registry():
    reg = MetricsRegistry()
    prev = set_registry(reg)
    yield reg
    set_registry(prev)


# -- assignor: invariants + stickiness ----------------------------------------

def _check_assignment(n, consumers, prior):
    """The three guarantees every assignment must satisfy, plus idempotence
    (re-assigning with the result as prior reproduces the result)."""
    asn = sticky_assign(n, consumers, prior)
    members = sorted(set(consumers))
    assert sorted(asn) == members
    flat = [p for ps in asn.values() for p in ps]
    assert sorted(flat) == list(range(n)), "every partition exactly once"
    if members:
        sizes = [len(ps) for ps in asn.values()]
        assert max(sizes) - min(sizes) <= 1, "balance within one partition"
    assert sticky_assign(n, consumers, asn) == asn, "sticky fixpoint"
    return asn


def test_torch_assignor_basic_shapes():
    assert sticky_assign(4, []) == {}
    assert sticky_assign(0, ["a"]) == {"a": []}
    assert sticky_assign(4, ["a"]) == {"a": [0, 1, 2, 3]}
    # fresh assignment round-robins free partitions to the least loaded
    assert sticky_assign(4, ["a", "b"]) == {"a": [0, 2], "b": [1, 3]}
    # 3 consumers, 4 partitions: exactly one member sits at the cap
    asn = sticky_assign(4, ["a", "b", "c"])
    assert sorted(len(ps) for ps in asn.values()) == [1, 1, 2]
    with pytest.raises(ValueError):
        sticky_assign(-1, ["a"])


def test_torch_assignor_survivors_keep_partitions():
    prior = sticky_assign(6, ["a", "b", "c"])
    after = sticky_assign(6, ["a", "b"], prior)
    for c in ("a", "b"):                   # only the dead member's moved
        assert set(prior[c]) <= set(after[c])
    _check_assignment(6, ["a", "b"], prior)


def test_torch_assignor_scale_out_moves_minimum():
    prior = sticky_assign(8, ["a", "b"])
    after = _check_assignment(8, ["a", "b", "c"], prior)
    kept = sum(len(set(prior[c]) & set(after[c])) for c in ("a", "b"))
    assert kept >= 5                       # 8->[3,3,2]: at most 3 moved
    assert len(after["c"]) >= 2


def test_torch_assignor_ignores_stale_prior_claims():
    # prior claims outside [0, n) or duplicated across members are dropped
    asn = _check_assignment(4, ["a", "b"],
                            {"a": [0, 1, 9, -1], "b": [1, 2, 3]})
    assert asn["a"] == [0, 1]
    assert asn["b"] == [2, 3]


def test_torch_assignor_property_sweep_seeded():
    """Deterministic stand-in for the hypothesis suite: 300 random
    (partitions, membership, prior) shapes, including priors from previous
    memberships (the rebalance case) and garbage priors."""
    rng = random.Random(0xC0FFEE)
    for _ in range(300):
        n = rng.randrange(0, 13)
        k = rng.randrange(1, 7)
        consumers = [f"c{i}" for i in range(k)]
        kind = rng.randrange(3)
        if kind == 0:
            prior = None
        elif kind == 1:                    # prior from an older membership
            old = rng.sample(consumers, rng.randrange(1, k + 1))
            prior = sticky_assign(n, old)
        else:                              # garbage prior
            prior = {c: [rng.randrange(-2, n + 3)
                         for _ in range(rng.randrange(0, n + 1))]
                     for c in rng.sample(consumers, rng.randrange(0, k + 1))}
        _check_assignment(n, consumers, prior)


@settings(max_examples=200, deadline=None)
@given(n=st.integers(min_value=0, max_value=16),
       k=st.integers(min_value=1, max_value=6),
       drop=st.integers(min_value=0, max_value=5),
       data=st.data())
def test_torch_assignor_properties_hypothesis(n, k, drop, data):
    consumers = [f"c{i}" for i in range(k)]
    old = consumers[:max(1, k - drop)]
    prior = sticky_assign(n, old) if data.draw(st.booleans()) else None
    _check_assignment(n, consumers, prior)


# -- coordinator: membership, liveness, fencing (fake clock) ------------------

def _fake_clock():
    t = {"now": 0.0}
    return t, (lambda: t["now"])


def _coord_broker(partitions=4, registry=None):
    broker = Broker()
    broker.create_topic("t", partitions)
    t, clock = _fake_clock()
    # install before the first group op: Broker.coordinator is lazy
    broker._coordinator = GroupCoordinator(broker, clock=clock)
    return broker, t, clock


def test_torch_join_sync_two_phase_and_generation_converges():
    broker, t, clock = _coord_broker()
    r1 = broker.join_group("g", "a", ["t"])
    assert r1 == {"generation": 1, "members": ["a"]}
    assert broker.sync_group("g", "a", 1) == {"t": [0, 1, 2, 3]}
    r2 = broker.join_group("g", "b", ["t"])
    assert r2["generation"] == 2 and r2["members"] == ["a", "b"]
    # a's sync at the old generation is fenced; at the new one it halves
    with pytest.raises(StaleGenerationError):
        broker.sync_group("g", "a", 1)
    # convergence: rejoining with unchanged membership does NOT bump again
    assert broker.join_group("g", "a", ["t"])["generation"] == 2
    assert broker.sync_group("g", "a", 2) == {"t": [0, 1]}
    assert broker.sync_group("g", "b", 2) == {"t": [2, 3]}
    assert broker.join_group("g", "b", ["t"])["generation"] == 2


def test_torch_join_validates_inputs():
    broker, _, _ = _coord_broker()
    with pytest.raises(GroupError):
        broker.join_group("g", "", ["t"])
    with pytest.raises(GroupError):
        broker.join_group("g", "a", ["t"], session_timeout=0)
    with pytest.raises(GroupError):
        broker.heartbeat("nope", "a", 1)   # unknown group


def test_torch_heartbeat_expiry_evicts_and_reassigns(fresh_registry):
    broker, t, clock = _coord_broker()
    a = GroupMember(broker, "g", "a", ["t"], session_timeout=5.0, clock=clock)
    b = GroupMember(broker, "g", "b", ["t"], session_timeout=5.0, clock=clock)
    a.join()
    b.join()
    a.maintain(force=True)                 # a catches up to b's generation
    assert a.partitions("t") == [0, 1] and b.partitions("t") == [2, 3]
    t["now"] = 3.0
    a.maintain(force=True)                 # a renews its lease; b goes dark
    t["now"] = 6.0                         # past b's deadline, inside a's
    changed = a.maintain(force=True)       # survivor's heartbeat evicts b
    assert changed and a.partitions("t") == [0, 1, 2, 3]
    d = broker.describe_group("g")
    assert sorted(d["members"]) == ["a"]
    evicted = fresh_registry.counter("group_members_evicted_total",
                                     labels={"group": "g"})
    assert evicted.value() == 1
    # the evicted member's next maintain() rejoins from scratch (sticky: it
    # may get the very partitions back, so "changed" can legitimately be
    # False — membership is what proves the rejoin)
    b.maintain(force=True)
    assert sorted(broker.describe_group("g")["members"]) == ["a", "b"]
    a.maintain(force=True)
    assert sorted(a.partitions("t") + b.partitions("t")) == [0, 1, 2, 3]
    assert set(a.partitions("t")).isdisjoint(b.partitions("t"))


def test_torch_commit_fencing_stale_generation_and_unowned_partition():
    broker, t, clock = _coord_broker(partitions=2)
    for p in range(2):
        for i in range(4):
            broker.produce("t", i, partition=p)
    a = GroupMember(broker, "g", "a", ["t"], clock=clock)
    a.join()
    gen1 = a.generation
    broker.commit("t", 0, 2, group="g", consumer="a", generation=gen1)
    assert broker.committed("t", group="g") == [2, 0]
    b = GroupMember(broker, "g", "b", ["t"], clock=clock)
    b.join()                               # generation moves on under a
    with pytest.raises(StaleGenerationError):
        broker.commit("t", 0, 4, group="g", consumer="a", generation=gen1)
    a.maintain(force=True)                 # rejoin at the new generation
    assert a.partitions("t") == [0]
    with pytest.raises(StaleGenerationError):   # b's partition, not a's
        broker.commit("t", 1, 4, group="g", consumer="a",
                      generation=a.generation)
    with pytest.raises(StaleGenerationError):   # never a member at all
        broker.commit("t", 0, 4, group="g", consumer="ghost",
                      generation=a.generation)
    broker.commit("t", 0, 4, group="g", consumer="a",
                  generation=a.generation)
    assert broker.committed("t", group="g") == [4, 0]
    # the fenced commits advanced nothing and the default group is untouched
    assert broker.committed("t") == [0, 0]


def test_torch_graceful_leave_rebalances_immediately():
    broker, t, clock = _coord_broker()
    a = GroupMember(broker, "g", "a", ["t"], clock=clock)
    b = GroupMember(broker, "g", "b", ["t"], clock=clock)
    a.join()
    b.join()
    b.leave()                              # no expiry wait
    assert b.generation == -1 and b.assignment == {}
    a.maintain(force=True)
    assert a.partitions("t") == [0, 1, 2, 3]
    assert a.generation == broker.describe_group("g")["generation"]
    a.leave()
    assert broker.describe_group("g")["members"] == {}


def test_torch_join_leave_churn_settles_balanced():
    broker, t, clock = _coord_broker(partitions=8)
    members = [GroupMember(broker, "g", f"m{i}", ["t"], clock=clock)
               for i in range(5)]
    for m in members:
        m.join()

    def settle_and_check(live):
        for m in live:
            m.maintain(force=True)
        flat = sorted(p for m in live for p in m.partitions("t"))
        assert flat == list(range(8)), "cover every partition exactly once"
        sizes = [len(m.partitions("t")) for m in live]
        assert max(sizes) - min(sizes) <= 1
        # settled: another maintain round changes nothing
        assert not any(m.maintain(force=True) for m in live)

    settle_and_check(members)
    for i in range(3):                     # waves of leave + rejoin
        members[i].leave()
        settle_and_check(members[:i] + members[i + 1:])
        members[i].join()
        settle_and_check(members)


def test_torch_group_metrics_gauges_and_counters(fresh_registry):
    broker, t, clock = _coord_broker()
    for i in range(10):
        broker.produce("t", i, partition=0)
    a = GroupMember(broker, "g", "a", ["t"], clock=clock)
    b = GroupMember(broker, "g", "b", ["t"], clock=clock)
    a.join()
    b.join()
    reg = fresh_registry
    assert reg.gauge("group_members", labels={"group": "g"}).value() == 2
    assert reg.gauge("group_generation", labels={"group": "g"}).value() == 2
    assert reg.counter("group_rebalances_total",
                       labels={"group": "g"}).value() == 2
    lag = reg.gauge("group_lag", labels={"group": "g", "topic": "t"})
    assert lag.value() == 10
    a.maintain(force=True)
    broker.commit("t", 0, 10, group="g", consumer="a",
                  generation=a.generation)
    assert lag.value() == 0


def test_torch_describe_unknown_group_is_empty():
    broker, _, _ = _coord_broker()
    assert broker.describe_group("nope") == {
        "group": "nope", "generation": 0, "members": {}, "assignments": {}}


# -- over the wire: group ops + error types cross the socket ------------------

def test_torch_group_protocol_over_socket(tmp_path):
    broker = Broker()
    broker.create_topic("t", 4)
    for i in range(8):
        broker.produce("t", i, partition=0)
    server = serve_broker(broker, str(tmp_path / "b.sock"))
    rb = RemoteBroker(server.address)
    try:
        gen = rb.join_group("g", "c1", ["t"])["generation"]
        assert rb.sync_group("g", "c1", gen) == {"t": [0, 1, 2, 3]}
        assert rb.heartbeat("g", "c1", gen) == {"generation": gen,
                                                "rebalance": False}
        rb.commit("t", 0, 8, group="g", consumer="c1", generation=gen)
        assert rb.lag("t", group="g") == 0 and rb.lag("t") == 8
        with pytest.raises(StaleGenerationError):   # the exact type survives
            rb.commit("t", 0, 8, group="g", consumer="c1",
                      generation=gen + 5)
        with pytest.raises(GroupError):
            rb.heartbeat("g", "nobody", 1)
        assert sorted(rb.commit_groups("t")) == ["", "g"]
        assert list(rb.describe_group("g")["members"]) == ["c1"]
        rb.leave_group("g", "c1")
        assert rb.describe_group("g")["members"] == {}
    finally:
        rb.close()
        server.stop()


# -- StreamingContext group mode ----------------------------------------------

def test_torch_streaming_contexts_split_partitions_disjoint():
    broker = Broker()
    broker.create_topic("t", 4)
    s1 = StreamingContext(Context(), broker, max_records_per_partition=5)
    s2 = StreamingContext(Context(), broker, max_records_per_partition=5)
    seen = {"c1": [], "c2": []}
    for sc, cid in ((s1, "c1"), (s2, "c2")):
        sc.subscribe(["t"])
        sc.foreach_batch(lambda rdd, info, c=cid: seen[c].extend(rdd.collect()))
        sc.join_group("g", consumer_id=cid)
    # both members must see the settled assignment BEFORE records flow —
    # otherwise c1 (which joined alone at generation 1) legally consumes
    # partitions it is about to lose, and the handoff replays them (the
    # documented at-least-once overlap, absorbed by idempotent sinks)
    s1.group_member.maintain(force=True)
    for p in range(4):
        for i in range(10):
            broker.produce("t", p * 100 + i, partition=p)
    while s1.run_one_batch() is not None or s2.run_one_batch() is not None:
        pass
    assert set(seen["c1"]).isdisjoint(seen["c2"])
    assert sorted(seen["c1"] + seen["c2"]) == sorted(
        p * 100 + i for p in range(4) for i in range(10))
    assert broker.lag("t", group="g") == 0
    assert broker.lag("t") == 40           # default group never advanced
    s1.close()
    s2.close()
    assert broker.describe_group("g")["members"] == {}


def test_torch_streaming_context_survives_fenced_commit():
    """A context whose group commit comes back fenced must not crash the
    batch loop: it logs, requests a resync, rejoins, and keeps consuming."""
    broker = Broker()
    broker.create_topic("t", 2)
    sc = StreamingContext(Context(), broker, max_records_per_partition=5)
    sc.subscribe(["t"])
    got = []
    sc.foreach_batch(lambda rdd, info: got.extend(rdd.collect()))
    member = sc.join_group("g", consumer_id="c1")
    for i in range(10):
        broker.produce("t", i, partition=0)
    sc.run_one_batch()
    # the group moves on behind the context's back -> its commit is fenced
    broker.join_group("g", "intruder", ["t"])
    sc.run_one_batch()                     # fenced commit -> resync requested
    while sc.run_one_batch() is not None:
        pass
    assert member.generation == broker.describe_group("g")["generation"]
    assert sorted(got) == list(range(10))
    sc.close()


# -- GroupConsumer: open-window handoff ---------------------------------------

def _win_files(outdir):
    out = {}
    for name in sorted(os.listdir(outdir)):
        if name.endswith(".json"):
            with open(os.path.join(outdir, name)) as f:
                out[name[:-5]] = json.load(f)
    return out


def _expected_windows(partitions, total, size):
    return {f"p{p}-w{k:04d}": [p * 1000 + k * size + i for i in range(size)]
            for p in range(partitions) for k in range(total // size)}


def _fire_to(outdir):
    def fn(part, records, winfo):
        tmp = os.path.join(outdir, f".p{part}-w{winfo.index:04d}.tmp")
        with open(tmp, "w") as f:
            json.dump(records, f)
        # analyze: ok replace-without-fsync - atomicity vs the reader below, not crash durability
        os.replace(tmp, os.path.join(outdir, f"p{part}-w{winfo.index:04d}.json"))
    return fn


def test_torch_group_consumer_graceful_handoff_replays_open_window(tmp_path):
    """c1 leaves mid-window; c2 restores c1's open window from the handoff
    checkpoint and the merged output equals an uninterrupted run."""
    broker = Broker()
    broker.create_topic("t", 2)
    for p in range(2):
        for i in range(50):
            broker.produce("t", p * 1000 + i, partition=p)
    outdir = str(tmp_path / "windows")
    os.makedirs(outdir)

    def mk(cid):
        return GroupConsumer(broker, "g", "t", str(tmp_path / "state"),
                             window=WindowSpec(size=20),
                             window_fn=_fire_to(outdir), consumer_id=cid,
                             max_records_per_partition=7)

    c1, c2 = mk("c1"), mk("c2")
    c1.member.maintain(force=True)
    assert sorted(c1.partitions + c2.partitions) == [0, 1]
    for _ in range(2):                     # both sit mid-window (14 of 20)
        c1.step()
        c2.step()
    c1.close()                             # graceful: immediate rebalance
    c2.member.maintain(force=True)
    assert c2.partitions == [0, 1]
    while c2.step() is not None:
        pass
    assert _win_files(outdir) == _expected_windows(2, 40, 20)
    assert broker.lag("t", group="g") == 0
    c2.close()


def test_torch_group_consumer_scale_out_keeps_window_continuity(tmp_path):
    """The opposite migration: c1 owns everything, consumes mid-window, then
    c2 joins and takes half — including an open window c1 had started."""
    broker = Broker()
    broker.create_topic("t", 2)
    for p in range(2):
        for i in range(50):
            broker.produce("t", p * 1000 + i, partition=p)
    outdir = str(tmp_path / "windows")
    os.makedirs(outdir)

    def mk(cid):
        return GroupConsumer(broker, "g", "t", str(tmp_path / "state"),
                             window=WindowSpec(size=20),
                             window_fn=_fire_to(outdir), consumer_id=cid,
                             max_records_per_partition=7)

    c1 = mk("c1")
    assert c1.partitions == [0, 1]
    for _ in range(2):
        c1.step()
    c2 = mk("c2")                          # scale-out: c1 must shed one
    c1.member.maintain(force=True)
    assert sorted(c1.partitions + c2.partitions) == [0, 1]
    assert len(c1.partitions) == 1 and len(c2.partitions) == 1
    while c1.step() is not None or c2.step() is not None:
        pass
    assert _win_files(outdir) == _expected_windows(2, 40, 20)
    assert broker.lag("t", group="g") == 0
    c1.close()
    c2.close()


def test_torch_fenced_batch_never_advances_past_unpushed_records(tmp_path):
    """The startup-storm loss the chaos suite flushed out, made
    deterministic: an intruder bumps the generation behind c1's back, so
    c1's next batch is fenced on every range. The batch must abort without
    advancing the context's local cursor — c1 *keeps* partition 0 after the
    resync, and a quietly skipped range would drop records [0, 7) from the
    window stream forever (all offsets committed, final window never
    fires)."""
    broker = Broker()
    broker.create_topic("t", 2)
    for p in range(2):
        for i in range(40):
            broker.produce("t", p * 1000 + i, partition=p)
    outdir = str(tmp_path / "windows")
    os.makedirs(outdir)
    gc = GroupConsumer(broker, "g", "t", str(tmp_path / "state"),
                       window=WindowSpec(size=20),
                       window_fn=_fire_to(outdir), consumer_id="c1",
                       max_records_per_partition=7,
                       heartbeat_interval=100.0)  # never notices gen 2 early
    try:
        assert gc.partitions == [0, 1]
        broker.join_group("g", "x", ["t"])     # gen 2: c1 silently loses p1
        # c1 still believes generation 1: every range in this batch is
        # fenced, the batch aborts, nothing is pushed or committed
        assert gc.step() is None
        assert broker.committed("t", group="g") == [0, 0]
        broker.leave_group("g", "x")           # gen 3: c1 owns both again
        expect = _expected_windows(2, 40, 20)
        assert gc.run_until(
            lambda: set(_win_files(outdir)) == set(expect), timeout=30)
        assert _win_files(outdir) == expect    # records [0, 7) not dropped
        assert broker.lag("t", group="g") == 0
    finally:
        gc.close()


# -- the chaos suite: SIGKILL a consumer process mid-window -------------------

_GWIN = 20
_GTOTAL = 240                              # per partition -> 12 windows each


def _chaos_fire(outdir, part, records, winfo):
    tmp = os.path.join(outdir, f".p{part}-w{winfo.index:04d}.tmp")
    with open(tmp, "w") as f:
        json.dump(records, f)
    # analyze: ok replace-without-fsync - atomicity vs the reader below, not crash durability
    os.replace(tmp, os.path.join(outdir, f"p{part}-w{winfo.index:04d}.json"))


def _chaos_child(address, root, cid, stopfile):
    """Child process: one group consumer over the socket transport, slow
    enough to be caught mid-window, heartbeating fast enough that survivors
    evict a SIGKILLed sibling in ~1s."""
    import functools

    remote = RemoteBroker(address)
    gc = GroupConsumer(
        remote, "g", "t", os.path.join(root, "state"),
        window=WindowSpec(size=_GWIN),
        window_fn=functools.partial(_chaos_fire,
                                    os.path.join(root, "windows")),
        consumer_id=cid, max_records_per_partition=7,
        heartbeat_interval=0.2, session_timeout=1.0, per_batch_sleep=0.05)
    while not os.path.exists(stopfile):
        if gc.step() is None:
            time.sleep(0.01)
    gc.close()
    remote.close()


def _read_ckpt(root, p):
    try:
        with open(os.path.join(root, "state", f"t-p{p}", "ckpt.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def test_torch_sigkill_consumer_mid_window_partition_handoff(tmp_path):
    """The acceptance test: three consumer processes share a 3-partition
    topic through the group protocol; one is SIGKILLed mid-window. The
    survivors must evict it by heartbeat expiry, adopt its partition,
    replay the open window from the dead owner's last atomic (offset, state
    ref) checkpoint, and finish with the exact window set an uncrashed run
    produces — duplicates absorbed by the idempotent window files, group
    lag drained to zero."""
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "windows"))
    broker = Broker()
    broker.create_topic("t", 3)
    for p in range(3):
        broker.produce_many(
            "t", [(None, p * 1000 + i) for i in range(_GTOTAL)], partition=p)
    server = serve_broker(broker, os.path.join(root, "b.sock"))
    stopfile = os.path.join(root, "stop")
    ctx = mp.get_context("spawn")
    procs = {cid: ctx.Process(target=_chaos_child,
                              args=(server.address, root, cid, stopfile),
                              daemon=True)
             for cid in ("c0", "c1", "c2")}
    try:
        for proc in procs.values():
            proc.start()
        coord = broker.coordinator

        def owned_parts(d):
            return sorted(p for a in d["assignments"].values()
                          for p in a.get("t", []))

        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:     # all three joined + settled
            d = coord.describe("g")
            if len(d["members"]) == 3 and owned_parts(d) == [0, 1, 2]:
                break
            time.sleep(0.01)
        else:
            pytest.fail("group never settled with 3 members")
        gen_settled = d["generation"]
        victim = "c0"
        (vpart,) = d["assignments"][victim]["t"]

        # kill only once the victim's open window is non-empty: offsets
        # checkpointed past a window boundary, records buffered past it
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if not procs[victim].is_alive():
                pytest.fail("victim exited before it could be killed")
            off = int(_read_ckpt(root, vpart).get("offset", 0))
            if off >= 3 * _GWIN and off % _GWIN != 0:
                os.kill(procs[victim].pid, signal.SIGKILL)
                break
            time.sleep(0.002)
        else:
            pytest.fail("never caught the victim mid-window")
        procs[victim].join(timeout=30)

        expect = _expected_windows(3, _GTOTAL, _GWIN)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:     # survivors finish the topic
            done = set(_win_files(os.path.join(root, "windows")))
            if done == set(expect) and broker.lag("t", group="g") == 0:
                break
            time.sleep(0.05)
        else:
            missing = sorted(set(expect) -
                             set(_win_files(os.path.join(root, "windows"))))
            pytest.fail(f"survivors never finished; missing {missing[:6]}, "
                        f"group lag {broker.lag('t', group='g')}")

        d = coord.describe("g")                # before the graceful shutdown
        assert victim not in d["members"], "victim must be evicted"
        assert sorted(d["members"]) == ["c1", "c2"]
        assert owned_parts(d) == [0, 1, 2], "orphaned partition re-assigned"
        assert d["generation"] > gen_settled, "eviction bumped the generation"
        new_owner = _read_ckpt(root, vpart).get("owner")
        assert new_owner in ("c1", "c2")
    finally:
        with open(stopfile, "w"):
            pass
        for proc in procs.values():
            proc.join(timeout=30)
        server.stop()

    got = _win_files(os.path.join(root, "windows"))
    assert got == expect, (
        f"killed {victim} on partition {vpart}: merged survivor output must "
        f"equal the uncrashed window set")


# -- crash/restart of a whole group member with in-process threads ------------

def test_torch_abandoned_member_is_evicted_and_partition_resumes(tmp_path):
    """In-process version of the chaos test's liveness path, deterministic:
    abandon() drops a consumer without leaving (a crash, minus the process),
    and the survivor — whose heartbeats drive lazy expiry on a fake clock —
    adopts the orphaned partition and replays its open window."""
    clockbox, clock = _fake_clock()
    broker = Broker()
    broker.create_topic("t", 2)
    broker._coordinator = GroupCoordinator(broker, clock=clock)
    for p in range(2):
        for i in range(50):
            broker.produce("t", p * 1000 + i, partition=p)
    outdir = str(tmp_path / "windows")
    os.makedirs(outdir)

    def mk(cid):
        gc = GroupConsumer(broker, "g", "t", str(tmp_path / "state"),
                           window=WindowSpec(size=20),
                           window_fn=_fire_to(outdir), consumer_id=cid,
                           max_records_per_partition=7, session_timeout=1.0)
        gc.member._clock = clock           # fake time drives the lease too
        return gc

    c1, c2 = mk("c1"), mk("c2")
    c1.member.maintain(force=True)
    for _ in range(2):                     # both mid-window at offset 14
        c1.step()
        c2.step()
    c1.abandon()                           # crash: no leave_group
    assert sorted(broker.describe_group("g")["members"]) == ["c1", "c2"]
    clockbox["now"] += 2.0                 # c1's lease expires
    c2.member.maintain(force=True)         # survivor's heartbeat evicts it
    assert sorted(broker.describe_group("g")["members"]) == ["c2"]
    assert c2.partitions == [0, 1]
    while c2.step() is not None:
        pass
    assert _win_files(outdir) == _expected_windows(2, 40, 20)
    assert broker.lag("t", group="g") == 0
    c2.close()


def test_torch_in_process_group_threads_spawn_nothing_extra():
    before = threading.active_count()
    test_torch_streaming_contexts_split_partitions_disjoint()
    # collect()'s executor pool shuts down with wait=False, so under load
    # its workers can outlive the call — give them a beat to exit before
    # holding the count to "nothing extra" (i.e. nothing *persistent*)
    deadline = time.monotonic() + 5.0
    while (threading.active_count() > before
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert threading.active_count() == before


def test_torch_run_until_zero_timeout_is_immediate_not_forever(tmp_path):
    """timeout=0 means "the deadline already passed": run_until must return
    False at once, before stepping a batch — the old truthiness-tested
    deadline treated 0 as "no deadline" and would spin forever on a
    predicate that never comes true."""
    broker = Broker()
    broker.create_topic("t", 1)
    for i in range(5):
        broker.produce("t", i)
    outdir = str(tmp_path / "w")
    os.makedirs(outdir)
    gc = GroupConsumer(broker, "g", "t", str(tmp_path / "state"),
                       window=WindowSpec(size=100),
                       window_fn=_fire_to(outdir), consumer_id="c1")
    try:
        t0 = time.perf_counter()
        assert gc.run_until(lambda: False, timeout=0) is False
        assert time.perf_counter() - t0 < 1.0
        assert broker.committed("t", group="g") == [0]  # nothing consumed
        # an already-satisfied predicate still wins at timeout=0...
        assert gc.run_until(lambda: True, timeout=0) is True
        # ...and a real timeout still lets work proceed
        assert gc.run_until(lambda: broker.lag("t", group="g") == 0,
                            timeout=30) is True
    finally:
        gc.close()


# -- the same protocol as the reference ---------------------------------------

def test_torch_sticky_assign_equals_the_reference_on_seeded_sequences():
    """Membership sequences from a seed — joins, leaves and garbage priors —
    fed to both assignors, each step's result the next step's prior: the
    port's assignment equals the reference's at every step."""
    from repro.data.groups import sticky_assign as ref_assign

    rng = random.Random(1805)
    for _ in range(60):
        n = rng.randrange(0, 17)
        pool = [f"c{i}" for i in range(rng.randrange(1, 8))]
        live = rng.sample(pool, rng.randrange(1, len(pool) + 1))
        prior = None
        for _ in range(12):
            if rng.random() < 0.5 and len(live) > 1:
                live.remove(rng.choice(live))
            else:
                live.append(rng.choice(pool))
            if rng.random() < 0.1:         # a garbage prior now and then
                prior = {c: [rng.randrange(-2, n + 3) for _ in range(3)]
                         for c in rng.sample(pool, min(2, len(pool)))}
            got = sticky_assign(n, live, prior)
            assert got == ref_assign(n, live, prior)
            prior = got


def _script_run(broker_cls, coordinator_cls):
    """One join/leave/expiry script on a fake clock; returns every step's
    (generation, members, assignments) and the commit verdicts."""
    now = {"t": 0.0}
    broker = broker_cls()
    broker.create_topic("t", 5)
    broker.create_topic("u", 2)
    for p in range(5):
        broker.produce("t", p, partition=p)
    broker._coordinator = coordinator_cls(broker, clock=lambda: now["t"])
    seen = []

    def snap():
        d = broker.describe_group("g")
        seen.append((d["generation"], sorted(d["members"]),
                     d["assignments"]))

    broker.join_group("g", "a", ["t"], session_timeout=2.0)
    snap()
    broker.join_group("g", "b", ["t", "u"], session_timeout=2.0)
    snap()
    broker.join_group("g", "a", ["t"], session_timeout=2.0)   # no change
    snap()
    broker.join_group("g", "c", ["u"], session_timeout=5.0)
    snap()
    now["t"] = 1.5
    broker.heartbeat("g", "a", seen[-1][0])
    broker.heartbeat("g", "c", seen[-1][0])
    now["t"] = 2.5                         # b's lease ran out at 2.0
    snap()
    broker.leave_group("g", "a")
    snap()
    broker.join_group("g", "d", ["t", "u"], session_timeout=2.0)
    snap()
    verdicts = []
    gen = seen[-1][0]
    for consumer, generation, partition in (("d", gen, 0), ("d", gen - 1, 0),
                                            ("b", gen, 0), ("c", gen, 0)):
        try:
            broker.commit("t", partition, 1, group="g", consumer=consumer,
                          generation=generation)
            verdicts.append("ok")
        except Exception as e:             # noqa: BLE001 - compared by name
            verdicts.append(type(e).__name__)
    return seen, verdicts, broker.committed("t", group="g")


def test_torch_coordinator_script_equals_the_reference():
    """The same join, leave and expiry script on a fake clock through the
    port's coordinator and the reference's: the same generations, members
    and assignments at every step, and the same commit verdicts."""
    from repro.core import Broker as RefBroker
    from repro.data.groups import GroupCoordinator as RefCoordinator

    port = _script_run(Broker, GroupCoordinator)
    assert port == _script_run(RefBroker, RefCoordinator)
    seen, verdicts, committed = port
    assert [g for g, _, _ in seen] == [1, 2, 2, 3, 4, 5, 6]
    assert seen[4][1] == ["a", "c"]        # b expired
    assert verdicts == ["ok", "StaleGenerationError", "StaleGenerationError",
                        "StaleGenerationError"]
    assert committed == [1, 0, 0, 0, 0]


@pytest.mark.parametrize("steps", [9, 12, 17])
def test_torch_handoff_after_a_mid_batch_window_keeps_every_record(tmp_path,
                                                                   steps):
    """A graceful handoff after ``steps`` batches of 7 over windows of 20,
    in both packages. The port's new owner fires every window with its
    records, whatever the handoff point. The reference loses the open
    window's records whenever a window that fired inside a batch is in the
    restored state's delta chain (offsets 84-119 here: its
    ``DurableStateStore`` delta fault), and the last window never fires —
    the reference chaos test's failure when its kill lands late."""
    from repro.core import Broker as RefBroker
    from repro.data import GroupConsumer as RefGroupConsumer
    from repro.data import WindowSpec as RefWindowSpec

    def run(broker_cls, consumer_cls, spec_cls, root):
        broker = broker_cls()
        broker.create_topic("t", 1)
        broker.produce_many("t", [(None, i) for i in range(240)],
                            partition=0)
        fired = {}

        def mk(cid):
            return consumer_cls(
                broker, "g", "t", str(root), window=spec_cls(size=20),
                window_fn=lambda p, recs, w: fired.__setitem__(
                    w.index, list(recs)),
                consumer_id=cid, max_records_per_partition=7)

        first = mk("c1")
        for _ in range(steps):
            first.step()
        first.close()
        second = mk("c2")
        while second.step() is not None:
            pass
        second.close()
        assert broker.lag("t", group="g") == 0
        return fired

    want = {k: list(range(20 * k, 20 * k + 20)) for k in range(12)}
    assert run(Broker, GroupConsumer, WindowSpec, tmp_path / "port") == want
    ref = run(RefBroker, RefGroupConsumer, RefWindowSpec, tmp_path / "ref")
    if 84 <= 7 * steps <= 119:
        assert sorted(set(want) - set(ref)) == [11]
    else:
        assert ref == want


def test_torch_fenced_commit_of_a_partitions_last_records_is_recommitted():
    """A streaming context's group commit is fenced on the batch that read
    a partition's last records (the generation moved twice behind its back,
    ownership unchanged). Its local cursor is past them, so no later batch
    commits them again. The port's context commits them under the
    generation it resyncs at, and the group's lag drains to zero; the
    reference's stays at the fenced batch's records for good."""
    from repro.core import Broker as RefBroker
    from repro.core import Context as RefContext
    from repro.core import StreamingContext as RefStreamingContext

    def run(broker_cls, context_cls, stream_cls):
        broker = broker_cls()
        broker.create_topic("t", 1)
        sc = stream_cls(context_cls(), broker)
        sc.subscribe(["t"])
        got = []
        sc.foreach_batch(lambda rdd, info: got.extend(rdd.collect()))
        sc.join_group("g", consumer_id="c1", heartbeat_interval=100.0)
        for i in range(10):
            broker.produce("t", i)
        broker.join_group("g", "x", ["t"])     # generation 2 ...
        broker.leave_group("g", "x")           # ... and 3: c1 keeps [0]
        assert sc.run_one_batch() is not None  # commit fenced at gen 1
        assert sc.run_one_batch() is None      # resync; no new records
        lag = broker.lag("t", group="g")
        assert got == list(range(10))
        sc.close()
        return lag

    assert run(Broker, Context, StreamingContext) == 0
    assert run(RefBroker, RefContext, RefStreamingContext) == 10
