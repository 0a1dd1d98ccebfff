"""Opt-in lock-order tracing, the counterpart of ``repro/data/locktrace.py``.

The port's data plane (broker, durable log, window-state store, delivery
lanes) takes its locks from :func:`new_lock` / :func:`new_rlock`: plain
``threading`` primitives unless a registry is :func:`enable`\\ d, so the hot
path costs nothing when tracing is off. While tracing is on:

- every acquisition records a *lock-order edge* (holder -> acquiree) into a
  process-wide :class:`LockRegistry`, keyed by lock *name* (one node per
  lock role, e.g. ``Broker._lock``, not per instance); a cycle in that
  graph is a potential deadlock even if the run never interleaved into it;
- fully-blocking calls (``queue.Queue.get`` and ``socket.recv``/
  ``recv_into`` with timeout ``None``) made while a traced lock is held are
  recorded as *hazards*: a peer that never answers turns the lock into a
  deadlock.

This registry is the port's own: the reference's (which the repository's
test configuration turns on for its chaos suites) cannot see the port's
locks, so the port's tests enable this one themselves and assert the
recorded graph is acyclic.
"""
from __future__ import annotations

import os
import queue
import socket
import threading
import traceback
from dataclasses import dataclass, field
from typing import Any

__all__ = ["TracingLock", "LockRegistry", "LockOrderReport", "enable",
           "disable", "active", "new_lock", "new_rlock", "tracing"]


@dataclass(frozen=True)
class Hazard:
    held: tuple[str, ...]     # traced locks held by the calling thread
    call: str                 # e.g. "queue.Queue.get(timeout=None)"
    site: str                 # "file:line" of the caller


@dataclass
class LockOrderReport:
    locks: set[str]
    edges: dict[tuple[str, str], str]   # (held, acquired) -> first site
    cycles: list[list[str]]
    hazards: list[Hazard]

    def describe(self) -> str:
        lines = [f"{len(self.locks)} lock(s), {len(self.edges)} order "
                 f"edge(s), {len(self.cycles)} cycle(s), "
                 f"{len(self.hazards)} hazard(s)"]
        for cyc in self.cycles:
            lines.append("  cycle: " + " -> ".join(cyc + cyc[:1]))
        for (a, b), site in sorted(self.edges.items()):
            lines.append(f"  edge: {a} -> {b}   [{site}]")
        for hz in self.hazards:
            lines.append(f"  hazard: {hz.call} while holding "
                         f"{', '.join(hz.held)}   [{hz.site}]")
        return "\n".join(lines)


def _call_site() -> str:
    # the most recent frame outside this module: the code doing the locking
    for frame in reversed(traceback.extract_stack(limit=12)):
        if os.path.basename(frame.filename) != "locktrace.py":
            return f"{frame.filename}:{frame.lineno}"
    return "?"


class LockRegistry:
    """Process-wide acquisition graph. Thread-safe; the per-acquire cost
    is a thread-local list append plus one set lookup for known edges."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._tls = threading.local()
        self._names: set[str] = set()
        self._edges: dict[tuple[str, str], str] = {}
        self._hazards: list[Hazard] = []

    # -- called by TracingLock (hot path) ----------------------------------
    def _stack(self) -> list:
        try:
            return self._tls.stack
        except AttributeError:
            stack = self._tls.stack = []
            return stack

    def _acquired(self, lock: "TracingLock") -> None:
        stack = self._stack()
        reentrant = any(l is lock for l in stack)
        if stack and not reentrant:
            edge = (stack[-1].name, lock.name)
            if edge not in self._edges:
                with self._mu:
                    self._edges.setdefault(edge, _call_site())
        stack.append(lock)

    def _released(self, lock: "TracingLock") -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is lock:
                del stack[i]
                return

    def _register(self, name: str) -> None:
        with self._mu:
            self._names.add(name)

    def _blocking_call(self, call: str) -> None:
        held = tuple(l.name for l in self._stack())
        if held:
            with self._mu:
                self._hazards.append(Hazard(held, call, _call_site()))

    # -- reporting ---------------------------------------------------------
    def cycles(self) -> list[list[str]]:
        """Strongly connected components of size > 1 (plus self-edges):
        each is a set of locks with no consistent global order."""
        with self._mu:
            edges = list(self._edges)
        adj: dict[str, list[str]] = {}
        for a, b in edges:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, [])
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on_stack: set[str] = set()
        stack: list[str] = []
        out: list[list[str]] = []
        counter = [0]

        def strongconnect(v: str) -> None:
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            for w in adj[v]:
                if w not in index:
                    strongconnect(w)
                    low[v] = min(low[v], low[w])
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == v:
                        break
                if len(scc) > 1 or (v, v) in edges:
                    out.append(sorted(scc))

        for v in adj:
            if v not in index:
                strongconnect(v)
        return out

    def report(self) -> LockOrderReport:
        with self._mu:
            locks = set(self._names)
            edges = dict(self._edges)
            hazards = list(self._hazards)
        return LockOrderReport(locks, edges, self.cycles(), hazards)


class TracingLock:
    """Drop-in ``threading.Lock``/``RLock`` that reports into a registry.

    Reentrant acquires of an RLock-flavored instance are recorded on the
    per-thread stack (so releases pair up) but never produce an order
    edge — holding a lock you already hold orders nothing.
    """

    __slots__ = ("name", "reentrant", "_reg", "_inner")

    def __init__(self, name: str, registry: LockRegistry,
                 reentrant: bool = False) -> None:
        self.name = name
        self.reentrant = reentrant
        self._reg = registry
        self._inner = threading.RLock() if reentrant else threading.Lock()
        registry._register(name)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._reg._acquired(self)
        return got

    def release(self) -> None:
        self._reg._released(self)
        self._inner.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def locked(self) -> bool:
        probe = getattr(self._inner, "locked", None)
        if probe is not None:
            return probe()
        # RLock before 3.13 has no locked(). A non-blocking probe alone
        # lies when *this* thread is the owner (it just re-enters), so
        # check ownership first; only then does probe-failure mean "held
        # by someone else".
        if self._inner._is_owned():
            return True
        if self._inner.acquire(blocking=False):
            self._inner.release()
            return False
        return True

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        kind = "RLock" if self.reentrant else "Lock"
        return f"<TracingLock {self.name} ({kind})>"


# -- process-wide switchboard ----------------------------------------------

_active: LockRegistry | None = None
_patches: list[tuple[Any, str, Any]] = []
_switch_mu = threading.Lock()


def active() -> LockRegistry | None:
    return _active


def new_lock(name: str) -> Any:
    """Construction seam: a plain ``threading.Lock`` normally, a traced
    lock while a registry is enabled."""
    reg = _active
    if reg is None:
        return threading.Lock()
    return TracingLock(name, reg)


def new_rlock(name: str) -> Any:
    reg = _active
    if reg is None:
        return threading.RLock()
    return TracingLock(name, reg, reentrant=True)


def _patch(obj: Any, attr: str, wrapper: Any) -> None:
    _patches.append((obj, attr, getattr(obj, attr)))
    setattr(obj, attr, wrapper)


def _install_blocking_probes(reg: LockRegistry) -> None:
    orig_get = queue.Queue.get

    def traced_get(self, block=True, timeout=None):
        if block and timeout is None:
            reg._blocking_call("queue.Queue.get(timeout=None)")
        return orig_get(self, block, timeout)

    _patch(queue.Queue, "get", traced_get)

    for meth in ("recv", "recv_into"):
        orig = getattr(socket.socket, meth)

        def traced_recv(self, *args, _orig=orig, _meth=meth, **kwargs):
            try:
                forever = self.gettimeout() is None
            except OSError:
                forever = False
            if forever:
                reg._blocking_call(f"socket.{_meth}(timeout=None)")
            return _orig(self, *args, **kwargs)

        _patch(socket.socket, meth, traced_recv)


def enable() -> LockRegistry:
    """Start tracing: subsequent :func:`new_lock`/:func:`new_rlock` calls
    hand out traced locks, and blocking-call probes go live."""
    global _active
    with _switch_mu:
        if _active is not None:
            raise RuntimeError("lock tracing already enabled")
        _active = reg = LockRegistry()
        _install_blocking_probes(reg)
        return reg


def disable() -> LockRegistry:
    """Stop tracing and return the registry (already-constructed traced
    locks keep recording into it — they just stop mattering once their
    components wind down)."""
    global _active
    with _switch_mu:
        if _active is None:
            raise RuntimeError("lock tracing is not enabled")
        reg, _active = _active, None
        while _patches:
            obj, attr, orig = _patches.pop()
            setattr(obj, attr, orig)
        return reg


class tracing:
    """``with locktrace.tracing() as reg: ...`` — scoped enable/disable."""

    def __enter__(self) -> LockRegistry:
        self._reg = enable()
        return self._reg

    def __exit__(self, *exc: Any) -> None:
        disable()
