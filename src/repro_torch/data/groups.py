"""Kafka-style consumer groups: coordinated partition ownership and
failover, the counterpart of ``repro/data/groups.py``.

One :class:`~repro_torch.core.dstream.StreamingContext` owning every
partition of a topic is a ceiling on consumer throughput and a single point
of failure. This module puts the group protocol on top of the broker's
committed offsets:

- :class:`GroupCoordinator` — broker-hosted group state (``Broker
  .coordinator`` creates one on first use; the ``join_group`` /
  ``heartbeat`` / ``sync_group`` / ``leave_group`` broker methods delegate
  to it and the socket transport serves them). Membership is leased: a
  member that stops heartbeating past its ``session_timeout`` is evicted on
  the next coordinator call — liveness is driven by the *survivors'*
  heartbeats, no background thread. Every membership change recomputes the
  assignment and bumps the group *generation*; commits carrying a stale
  generation (or a partition the member does not own) are fenced with
  :class:`StaleGenerationError`, so a zombie consumer cannot corrupt the
  group's progress signal.
- :func:`sticky_assign` — the partition assignor: balanced within one
  partition, every partition owned exactly once, and *sticky* — when
  membership is unchanged the assignment is unchanged, and survivors keep
  their partitions across a rebalance (only the dead member's partitions
  move, which is what makes window-state handoff cheap).
- :class:`GroupMember` — the client half: join and sync, periodic
  heartbeats (``maintain()``, called by the streaming context at the top of
  each micro-batch), rejoin on eviction or generation change, with an
  ``on_rebalance`` callback for the owner to acquire and release
  partitions.
- :class:`GroupConsumer` — a group-mode streaming consumer with
  **per-partition window-state handoff**: each owned partition gets its own
  :class:`~repro_torch.data.window.Windower`,
  :class:`~repro_torch.data.state.DurableStateStore` and offset checkpoint
  under a shared filesystem root, so when a partition migrates (crash,
  leave, scale-out) the new owner restores the open window from the dead
  owner's last committed ``(offset, state ref)`` pair and *replays* it
  instead of losing it — the restart path's both-or-neither argument, per
  partition instead of per process.

Convergence: ``join_group`` bumps the generation only when the computed
assignment actually changes. A member re-joining after it noticed a new
generation therefore does *not* trigger another rebalance — the protocol
settles in one round instead of ping-ponging generations.

Fencing vs. handoff: the broker-side group commit is *advisory* (lag signal
and zombie fencing); the per-partition checkpoint under the shared root is
*authoritative* for where a new owner resumes. A SIGKILLed owner's partition
replays from its last atomic (offset, ref) pair; outputs re-fired during the
replay carry the same window indices, so idempotent-by-key sinks absorb the
duplicates — exactly-once downstream, the contract the single-consumer
pipeline has.
"""
from __future__ import annotations

import json
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

from repro_torch.data import transport as _transport
from repro_torch.data.locktrace import new_rlock
from repro_torch.data.metrics import get_registry
from repro_torch.utils import get_logger

log = get_logger(__name__)

DEFAULT_SESSION_TIMEOUT = 5.0


class GroupError(ValueError):
    """Consumer-group protocol violation: unknown group/member, evicted
    member, malformed join. Members react by re-joining."""


class StaleGenerationError(GroupError):
    """A commit or sync carried a superseded generation (or a partition the
    member no longer owns): the caller was rebalanced away and must rejoin
    before touching group state again — Kafka's generation fencing."""


class _FencedBatch(Exception):
    """Internal to :class:`GroupConsumer`: a range's fence failed mid-batch.
    The whole batch aborts so the streaming context does not advance its
    local cursor past records the windower never saw (for a partition the
    member *keeps* after the resync, an advanced cursor would silently drop
    those records from the window stream). ``step()`` swallows it."""


# Group errors cross the socket as ("err", type_name, message) frames; map
# the names back to the real types so RemoteBroker raises what Broker raises.
_transport._ERR_TYPES.setdefault("GroupError", GroupError)
_transport._ERR_TYPES.setdefault("StaleGenerationError", StaleGenerationError)


# -- assignor ----------------------------------------------------------------

def sticky_assign(num_partitions: int, consumers: Sequence[str],
                  prior: Mapping[str, Sequence[int]] | None = None
                  ) -> dict[str, list[int]]:
    """Assign ``num_partitions`` partitions across ``consumers``.

    Guarantees (the property suites of the tests pin them):

    - every partition in ``[0, num_partitions)`` is assigned exactly once;
    - load is balanced within one partition (max - min owned <= 1);
    - *sticky*: a consumer keeps its ``prior`` partitions wherever the
      balance targets allow, and an unchanged membership with a balanced
      prior reproduces the prior exactly.

    Deterministic: ties break on sorted consumer name, released/unowned
    partitions are filled lowest-index-first to the least-loaded consumer.
    """
    if num_partitions < 0:
        raise ValueError("num_partitions must be >= 0")
    members = sorted(set(consumers))
    if not members:
        return {}
    prior = prior or {}
    base, extra = divmod(num_partitions, len(members))
    owned: dict[str, list[int]] = {}
    seen: set[int] = set()
    for c in members:                    # keep prior claims, first-come by
        kept = []                        # sorted name, dropping out-of-range
        for p in sorted(set(prior.get(c, ()))):
            if 0 <= p < num_partitions and p not in seen:
                seen.add(p)
                kept.append(p)
        owned[c] = kept
    cap = base + (1 if extra else 0)
    for c in members:                    # nobody keeps more than the cap
        while len(owned[c]) > cap:
            seen.discard(owned[c].pop())
    if extra:                            # and only `extra` members sit at cap
        over = [c for c in members if len(owned[c]) > base]
        for c in over[extra:]:
            while len(owned[c]) > base:
                seen.discard(owned[c].pop())
    for p in range(num_partitions):      # fill the released/unclaimed rest
        if p not in seen:
            c = min(members, key=lambda m: (len(owned[m]), m))
            owned[c].append(p)
    return {c: sorted(ps) for c, ps in owned.items()}


# -- coordinator (broker side) -----------------------------------------------

@dataclass
class _Member:
    topics: tuple
    session_timeout: float
    deadline: float                      # clock reading past which = dead


@dataclass
class _Group:
    name: str
    generation: int = 0
    members: dict = field(default_factory=dict)       # consumer -> _Member
    assignments: dict = field(default_factory=dict)   # consumer -> {t: [p]}
    m_rebalances: Any = None
    m_evicted: Any = None


class GroupCoordinator:
    """Broker-hosted group membership, liveness and assignment.

    Thread-free by design: member expiry is evaluated lazily at the top of
    every coordinator call against the injected ``clock`` (``time.monotonic``
    by default; tests inject a fake clock and install the coordinator via
    ``broker._coordinator`` before the first group op). All methods are
    thread-safe; lock order is coordinator -> broker, never the reverse.
    """

    def __init__(self, broker: Any = None,
                 clock: Callable[[], float] | None = None) -> None:
        self.broker = broker
        self._clock = clock or time.monotonic
        # traced under the lock-order harness, which pins the invariant:
        # coordinator -> broker, never the reverse
        self._lock = new_rlock("GroupCoordinator._lock")
        self._groups: dict[str, _Group] = {}
        self._lag_gauges: set[tuple[str, str]] = set()
        self._registry = get_registry()

    # -- group bookkeeping -------------------------------------------------
    def _group(self, name: str) -> _Group:
        g = self._groups.get(name)
        if g is None:
            g = self._groups[name] = _Group(name=name)
            reg = self._registry
            reg.gauge("group_members", "live members per consumer group",
                      labels={"group": name},
                      callback=lambda n=name: len(self._groups[n].members))
            reg.gauge("group_generation", "current group generation",
                      labels={"group": name},
                      callback=lambda n=name: self._groups[n].generation)
            g.m_rebalances = reg.counter(
                "group_rebalances_total",
                "generation bumps (assignment recomputed and changed)",
                labels={"group": name})
            g.m_evicted = reg.counter(
                "group_members_evicted_total",
                "members removed by heartbeat expiry", labels={"group": name})
        return g

    def _register_lag_gauge(self, group: str, topic: str) -> None:
        if self.broker is None or (group, topic) in self._lag_gauges:
            return
        self._lag_gauges.add((group, topic))
        self._registry.gauge(
            "group_lag", "produced-but-uncommitted records per group",
            labels={"group": group, "topic": topic},
            callback=lambda g=group, t=topic: self._safe_lag(t, g))

    def _safe_lag(self, topic: str, group: str) -> int:
        try:
            return self.broker.lag(topic, group=group)
        except Exception:                # topic gone / remote hiccup: a
            return 0                     # scrape must never raise

    def _num_partitions(self, topic: str) -> int | None:
        if self.broker is None:
            return None
        try:
            return self.broker.num_partitions(topic)
        except KeyError:
            return None

    def _rebalance(self, g: _Group) -> bool:
        """Recompute the full assignment; bump the generation only if it
        changed (re-joins by existing members converge instead of
        ping-ponging generations)."""
        topics = sorted({t for m in g.members.values() for t in m.topics})
        new: dict[str, dict[str, list[int]]] = {c: {} for c in g.members}
        for t in topics:
            subscribed = sorted(c for c, m in g.members.items()
                                if t in m.topics)
            n = self._num_partitions(t)
            if n is None:
                log.warning("group %r subscribes unknown topic %r; it gets "
                            "no partitions until it exists at a rebalance",
                            g.name, t)
                continue
            prior = {c: g.assignments.get(c, {}).get(t, [])
                     for c in subscribed}
            for c, parts in sticky_assign(n, subscribed, prior).items():
                if parts:
                    new[c][t] = parts
        if new == g.assignments:
            return False
        g.assignments = new
        g.generation += 1
        g.m_rebalances.inc()
        log.info("group %r generation %d: %s", g.name, g.generation,
                 {c: a for c, a in new.items()})
        # durable generation floor: on a broker with a commit topic this
        # event replicates to followers, so a promoted primary's coordinator
        # resumes generations *above* every pre-failover one — a zombie
        # consumer's stale-generation commit stays fenced across failover
        record = getattr(self.broker, "_record_group_event", None)
        if record is not None:
            record(("gen", g.name, g.generation))
        return True

    def seed_generation(self, group: str, generation: int) -> None:
        """Raise ``group``'s generation floor (promotion/restart path: the
        replayed commit log names the highest generation the old primary
        ever handed out; resuming below it would let zombie commits through
        the generation fence)."""
        with self._lock:
            g = self._group(group)
            g.generation = max(g.generation, int(generation))

    def _expire(self, g: _Group, now: float) -> None:
        dead = [c for c, m in g.members.items() if m.deadline <= now]
        for c in dead:
            del g.members[c]
            g.m_evicted.inc()
            log.warning("group %r: evicting %r (heartbeat expired)",
                        g.name, c)
        if dead:
            self._rebalance(g)

    def _live_member(self, group: str, consumer: str,
                     now: float) -> tuple[_Group, _Member]:
        g = self._groups.get(group)
        if g is None:
            raise GroupError(f"unknown group {group!r}")
        self._expire(g, now)
        m = g.members.get(consumer)
        if m is None:
            raise GroupError(
                f"consumer {consumer!r} is not a live member of group "
                f"{group!r} (evicted or never joined); rejoin")
        return g, m

    # -- protocol ----------------------------------------------------------
    def join_group(self, group: str, consumer: str, topics: Sequence[str],
                   session_timeout: float = DEFAULT_SESSION_TIMEOUT) -> dict:
        """Add/refresh a member; returns ``{"generation", "members"}``. The
        caller must follow with :meth:`sync_group` at that generation to
        learn its partitions (two-phase, like Kafka's JoinGroup/SyncGroup)."""
        if not consumer or not isinstance(consumer, str):
            raise GroupError("consumer id must be a non-empty string")
        if not (isinstance(session_timeout, (int, float))
                and session_timeout > 0):
            raise GroupError("session_timeout must be > 0")
        with self._lock:
            now = self._clock()
            g = self._group(group)
            self._expire(g, now)
            g.members[consumer] = _Member(
                topics=tuple(topics), session_timeout=float(session_timeout),
                deadline=now + float(session_timeout))
            self._rebalance(g)
            for t in topics:
                self._register_lag_gauge(group, t)
            return {"generation": g.generation, "members": sorted(g.members)}

    def heartbeat(self, group: str, consumer: str, generation: int) -> dict:
        """Renew the member's lease. ``rebalance`` in the response tells the
        member its generation is stale and it must rejoin + resync."""
        with self._lock:
            g, m = self._live_member(group, consumer, self._clock())
            m.deadline = self._clock() + m.session_timeout
            return {"generation": g.generation,
                    "rebalance": generation != g.generation}

    def sync_group(self, group: str, consumer: str,
                   generation: int) -> dict[str, list[int]]:
        """Fetch the member's assignment at ``generation``; fenced if the
        group moved on (the member rejoins and syncs at the new one)."""
        with self._lock:
            g, m = self._live_member(group, consumer, self._clock())
            if generation != g.generation:
                raise StaleGenerationError(
                    f"group {group!r} is at generation {g.generation}; "
                    f"{consumer!r} synced at {generation} — rejoin")
            m.deadline = self._clock() + m.session_timeout
            return {t: list(ps)
                    for t, ps in g.assignments.get(consumer, {}).items()}

    def leave_group(self, group: str, consumer: str) -> None:
        with self._lock:
            g = self._groups.get(group)
            if g is None:
                return
            self._expire(g, self._clock())
            if g.members.pop(consumer, None) is not None:
                log.info("group %r: %r left", group, consumer)
                self._rebalance(g)

    def check_commit(self, group: str, consumer: str | None, generation: int,
                     topic: str | None = None,
                     partition: int | None = None) -> None:
        """Fence a group offset commit: only a live member at the current
        generation that owns ``(topic, partition)`` may advance it. Raises
        :class:`StaleGenerationError` otherwise (``Broker.commit`` calls
        this for every generation-carrying commit)."""
        with self._lock:
            now = self._clock()
            g = self._groups.get(group)
            if g is None:
                raise GroupError(f"unknown group {group!r}")
            self._expire(g, now)
            if consumer not in g.members:
                raise StaleGenerationError(
                    f"commit fenced: {consumer!r} is not a live member of "
                    f"group {group!r}")
            if generation != g.generation:
                raise StaleGenerationError(
                    f"commit fenced: generation {generation} superseded by "
                    f"{g.generation} in group {group!r}")
            if topic is not None and partition is not None:
                parts = g.assignments.get(consumer, {}).get(topic, [])
                if partition not in parts:
                    raise StaleGenerationError(
                        f"commit fenced: {topic!r}[{partition}] is not "
                        f"assigned to {consumer!r} in group {group!r}")

    def describe(self, group: str) -> dict:
        """Group snapshot for tests/observability (also a broker op:
        ``describe_group`` over the transport)."""
        with self._lock:
            g = self._groups.get(group)
            if g is None:
                return {"group": group, "generation": 0, "members": {},
                        "assignments": {}}
            self._expire(g, self._clock())
            return {"group": group, "generation": g.generation,
                    "members": {c: {"topics": list(m.topics),
                                    "session_timeout": m.session_timeout}
                                for c, m in g.members.items()},
                    "assignments": {c: {t: list(ps) for t, ps in a.items()}
                                    for c, a in g.assignments.items()}}


# -- member (client side) ----------------------------------------------------

class GroupMember:
    """The client half of the protocol, driven by the owner's batch loop.

    ``maintain()`` is cheap when nothing is due (one clock read); on the
    heartbeat interval it renews the lease, and on eviction / generation
    change it re-joins and re-syncs, firing ``on_rebalance(old, new)`` with
    the before/after assignment whenever the owned partitions changed.
    """

    def __init__(self, broker: Any, group: str, consumer_id: str | None = None,
                 topics: Sequence[str] = (), *,
                 heartbeat_interval: float = 1.0,
                 session_timeout: float = DEFAULT_SESSION_TIMEOUT,
                 clock: Callable[[], float] | None = None,
                 on_rebalance: Callable[[dict, dict], None] | None = None
                 ) -> None:
        self.broker = broker
        self.group = group
        self.consumer_id = consumer_id or f"consumer-{uuid.uuid4().hex[:8]}"
        self.topics = list(topics)
        self.heartbeat_interval = heartbeat_interval
        self.session_timeout = session_timeout
        self.on_rebalance = on_rebalance
        self._clock = clock or time.monotonic
        self.generation = -1
        self.assignment: dict[str, list[int]] = {}
        self.rebalances = 0              # assignment changes seen
        self._last_hb = float("-inf")
        self._resync = False

    def join(self) -> bool:
        """Join + sync; returns True when the owned partitions changed
        (after firing ``on_rebalance``). Retries the sync when a concurrent
        join bumps the generation between our join and sync."""
        gen = self.broker.join_group(
            self.group, self.consumer_id, list(self.topics),
            session_timeout=self.session_timeout)["generation"]
        for _ in range(8):
            try:
                assignment = self.broker.sync_group(
                    self.group, self.consumer_id, gen)
                break
            except StaleGenerationError:
                gen = self.broker.join_group(
                    self.group, self.consumer_id, list(self.topics),
                    session_timeout=self.session_timeout)["generation"]
        else:
            raise GroupError(
                f"group {self.group!r} did not settle after 8 join/sync "
                "rounds (membership churning faster than we can sync)")
        self._last_hb = self._clock()
        self._resync = False
        self.generation = gen
        changed = assignment != self.assignment
        if changed:
            old, self.assignment = self.assignment, assignment
            self.rebalances += 1
            log.info("member %r generation %d owns %s", self.consumer_id,
                     gen, assignment)
            if self.on_rebalance is not None:
                self.on_rebalance(old, assignment)
        return changed

    def maintain(self, force: bool = False) -> bool:
        """Heartbeat/rejoin as due; returns True when ownership changed."""
        now = self._clock()
        if self._resync:
            return self.join()
        if not force and now - self._last_hb < self.heartbeat_interval:
            return False
        try:
            resp = self.broker.heartbeat(self.group, self.consumer_id,
                                         self.generation)
        except GroupError:               # evicted while away: start over
            return self.join()
        self._last_hb = now
        if resp["rebalance"]:
            return self.join()
        return False

    def request_resync(self) -> None:
        """Force a rejoin on the next :meth:`maintain` (called when a group
        commit came back fenced — the group moved on under us)."""
        self._resync = True

    def partitions(self, topic: str) -> list[int]:
        return list(self.assignment.get(topic, []))

    def leave(self) -> None:
        """Leave gracefully (immediate rebalance). Best-effort: if the
        broker is unreachable the coordinator evicts us by expiry anyway."""
        try:
            self.broker.leave_group(self.group, self.consumer_id)
        except Exception as e:           # noqa: BLE001 - teardown path
            log.warning("leave_group(%r, %r) failed (%s); coordinator will "
                        "evict on expiry", self.group, self.consumer_id, e)
        self.assignment = {}
        self.generation = -1


# -- group consumer: per-partition window-state handoff ----------------------

@dataclass
class _PartState:
    windower: Any
    store: Any
    offset: int                          # records consumed (authoritative)
    epoch: int                           # per-partition commit epoch
    path: str


class GroupConsumer:
    """A group-mode windowed consumer whose open windows survive handoff.

    Each owned partition keeps, under ``root/<topic>-p<N>/``, its own
    :class:`~repro_torch.data.state.DurableStateStore` plus a ``ckpt.json`` naming
    the last committed ``(offset, state ref, epoch, generation)`` — written
    tmp + fsync + ``os.replace``, so the pair is atomic exactly like the
    restart path's process checkpoint, but *per partition*: the unit of migration.
    On rebalance the member releases lost partitions and acquires gained
    ones by restoring the previous owner's pair, replaying the open window
    from the committed offset. Window outputs are re-fired with the same
    window indices on replay, so idempotent-by-key sinks keep end-to-end
    exactly-once across the handoff.

    ``window_fn(partition, records, window_info)`` is the user callback; it
    must be idempotent by ``(partition, window_info.index)`` — same
    discipline as every keyed sink in this repo.

    A *graceful* handoff (leave/scale-out) has no gap; a *crash* handoff
    replays at most the records between the dead owner's last per-partition
    commit and its death. The broker-side group commit runs *first* in each
    range — before the windower push and the state-log append — so a member
    the group has moved away from a partition is fenced *before* it can
    write into the new owner's state directory; a fenced range aborts the
    whole batch (the context must not advance past records the windower
    never saw — it may keep this very partition after the resync). For
    resume offsets the per-partition checkpoint stays authoritative (the
    broker commit is a lag signal and a fence, never the replay source).
    """

    def __init__(self, broker: Any, group: str, topic: str, root: str, *,
                 window: Any, window_fn: Callable[[int, list, Any], Any],
                 consumer_id: str | None = None,
                 batch_interval: float = 0.02,
                 max_records_per_partition: int | None = None,
                 heartbeat_interval: float = 1.0,
                 session_timeout: float = DEFAULT_SESSION_TIMEOUT,
                 per_batch_sleep: float = 0.0,
                 store_factory: Callable[[str], Any] | None = None) -> None:
        # imported here: the streaming context imports this module
        from repro_torch.core.dstream import StreamingContext
        from repro_torch.core.rdd import Context

        self.broker = broker
        self.group = group
        self.topic = topic
        self.root = str(root)
        self.spec = window
        self.window_fn = window_fn
        self.per_batch_sleep = per_batch_sleep
        self._store_factory = store_factory or _durable_store
        self._parts: dict[int, _PartState] = {}
        os.makedirs(self.root, exist_ok=True)
        self.sc = StreamingContext(
            Context(), broker, batch_interval=batch_interval,
            max_records_per_partition=max_records_per_partition)
        self.sc.subscribe([topic])
        self.sc.foreach_batch(self._on_batch)
        self.sc.join_group(
            group, consumer_id=consumer_id,
            heartbeat_interval=heartbeat_interval,
            session_timeout=session_timeout,
            start_offset=self._start_offset,
            on_rebalance=self._on_rebalance)

    @property
    def member(self):
        """The live :class:`GroupMember` (``None`` once closed/abandoned).
        A property over the context's member because the initial rebalance
        callback runs *inside* the join, before ``__init__`` could bind it."""
        return self.sc.group_member

    # -- per-partition checkpoints -----------------------------------------
    def _part_dir(self, p: int) -> str:
        return os.path.join(self.root, f"{self.topic}-p{p}")

    def _read_ckpt(self, p: int) -> dict:
        try:
            with open(os.path.join(self._part_dir(p), "ckpt.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _write_ckpt(self, p: int, st: _PartState, ref: int) -> None:
        path = os.path.join(st.path, "ckpt.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"offset": st.offset, "ref": ref, "epoch": st.epoch,
                       "generation": self.member.generation,
                       "owner": self.member.consumer_id}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    # -- acquire / release -------------------------------------------------
    def _acquire(self, p: int) -> _PartState:
        d = self._part_dir(p)
        os.makedirs(d, exist_ok=True)
        store = self._store_factory(os.path.join(d, "state"))
        ck = self._read_ckpt(p)
        windower = _make_windower(self.spec, self._emitter(p))
        state = store.restore(ck.get("ref"))
        if state is not None:
            windower.restore_state(state)
        st = _PartState(windower=windower, store=store,
                        offset=int(ck.get("offset", 0)),
                        epoch=int(ck.get("epoch", 0)), path=d)
        self._parts[p] = st
        log.info("%s acquired %s[%d] at offset %d (%d open-window records)",
                 self.member.consumer_id, self.topic, p, st.offset,
                 len(windower.state().buf))
        return st

    def _release(self, p: int) -> None:
        st = self._parts.pop(p, None)
        if st is not None:
            st.store.close()

    def _emitter(self, p: int) -> Callable:
        return lambda records, winfo: self.window_fn(p, records, winfo)

    def _on_rebalance(self, old: dict, new: dict) -> None:
        owned = set(new.get(self.topic, []))
        for p in sorted(set(self._parts) - owned):
            self._release(p)
        for p in sorted(owned):
            st = self._parts.get(p)
            if st is not None:
                # kept across the rebalance — but if we were evicted and the
                # partition ran under another owner meanwhile, our in-memory
                # state is stale: the on-disk pair is authoritative
                if int(self._read_ckpt(p).get("offset", 0)) != st.offset:
                    self._release(p)
                    self._acquire(p)
            else:
                self._acquire(p)

    def _start_offset(self, topic: str, partition: int) -> int | None:
        if topic != self.topic:
            return None
        st = self._parts.get(partition)
        if st is not None:
            return st.offset
        return int(self._read_ckpt(partition).get("offset", 0))

    # -- the batch function ------------------------------------------------
    def _on_batch(self, rdd: Any, info: Any) -> list:
        out = []
        member = self.member
        for rng in info.ranges:
            if rng.topic != self.topic:
                continue
            st = self._parts.get(rng.partition)
            if st is None:               # assignment raced the batch: late
                st = self._acquire(rng.partition)
            if rng.until <= st.offset:
                continue                 # replay of an already-committed range
            # Fence BEFORE touching the partition's shared durable state:
            # the generation-checked group commit rejects a member the group
            # rebalanced away from this partition, so a stale owner discards
            # its batch here instead of clobbering the new owner's state log
            # (two writers on one log: the zombie's compaction would
            # os.replace the file out from under the rightful owner).
            # A fenced range aborts the WHOLE batch (not just this range):
            # the context commits every range of a completed batch into its
            # local cursor, so skipping one quietly would advance past
            # records that never reached the windower — lost for good if the
            # resync hands this same partition back to us. Ranges already
            # processed above replay next batch and dedupe on st.offset.
            try:
                self.broker.commit(rng.topic, rng.partition, rng.until,
                                   group=self.group,
                                   consumer=member.consumer_id,
                                   generation=member.generation)
            except GroupError as e:
                member.request_resync()
                raise _FencedBatch(str(e)) from e
            records = [r.value for r in self.broker.read(rng)]
            skip = max(0, st.offset - rng.start)
            out.extend(st.windower.push(records[skip:], info))
            st.epoch += 1
            ref = st.store.commit(st.epoch, st.windower.state())
            st.offset = rng.until
            self._write_ckpt(rng.partition, st, ref)
        if self.per_batch_sleep:
            time.sleep(self.per_batch_sleep)
        return out

    # -- drive -------------------------------------------------------------
    def step(self):
        try:
            return self.sc.run_one_batch()
        except _FencedBatch as e:
            log.info("%s: batch fenced (%s); will resync",
                     getattr(self.member, "consumer_id", "<closed>"), e)
            return None

    def run_until(self, done: Callable[[], bool], idle_sleep: float = 0.005,
                  timeout: float | None = None) -> bool:
        """Run batches until ``done()``; False on timeout."""
        # `is not None`, not truthiness: timeout=0 means "deadline already
        # passed" (check once, give up immediately), never "wait forever"
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        while not done():
            if deadline is not None and time.monotonic() > deadline:
                return False
            if self.step() is None:
                time.sleep(idle_sleep)
        return True

    @property
    def partitions(self) -> list[int]:
        return sorted(self._parts)

    def abandon(self) -> None:
        """Simulate a crash for tests: drop all state without leaving — the
        coordinator must evict this member by heartbeat expiry."""
        for p in list(self._parts):
            self._release(p)
        self.sc.group_member = None      # close() must not leave gracefully
        self.sc.close(drain=False)

    def close(self) -> None:
        """Graceful exit: leave the group (immediate rebalance, no expiry
        wait), then release every partition's store — their last committed
        pairs stay on disk for the next owner."""
        self.sc.close()                  # leaves the group
        for p in list(self._parts):
            self._release(p)


def _durable_store(path: str):
    from repro_torch.data.state import DurableStateStore
    return DurableStateStore(path)


def _make_windower(spec: Any, fn: Callable):
    # imported here: the window module imports the streaming context, which
    # imports this one
    from repro_torch.data.window import Windower
    return Windower(spec, fn)
