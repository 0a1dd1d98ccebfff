"""Process Management Interface (PMI): the paper's wire-up layer.

The counterpart of ``repro/core/pmi.py``, line for line: the Spark-MPI
paper's PMI server (Hydra with process launching suppressed) lets Spark
worker closures become MPI ranks. Each worker needs only ``PMI_PORT`` and
``PMI_ID`` to join a key-value space (KVS), exchange connection info with
``put``/``get``, and synchronise with ``fence``.

* a KVS with PMI-1 ``put / fence / get`` semantics: gets observe only the
  puts from before the last fence;
* worker membership with heartbeats and **generations**: when a worker dies
  or joins, the generation bumps and the elastic runtime re-forms the
  worker set (``core/fault.py``);
* deterministic rank assignment within a generation (the ``PMI_ID`` role).

Everything is in-process (threads stand in for hosts). On the card the
transport itself is wired by ``torch.distributed``; the bridge publishes
each rank's device here and commits the KVS once (``core/bridge.py``).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any

from repro_torch.utils import get_logger

log = get_logger(__name__)


class PMIError(RuntimeError):
    pass


class KeyValueSpace:
    """PMI key-value space with put/fence/get semantics.

    Puts are staged per-worker and only become globally visible after a
    ``fence`` in which every registered worker participates (PMI-1's
    ``KVS_Commit`` + ``Barrier``). ``get`` on an uncommitted key raises —
    this is the property that makes rank wire-up race-free.
    """

    def __init__(self, name: str = "kvs_0") -> None:
        self.name = name
        self._lock = threading.Lock()
        self._committed: dict[str, Any] = {}
        self._staged: dict[int, dict[str, Any]] = {}
        self._fence_count = 0

    def put(self, rank: int, key: str, value: Any) -> None:
        with self._lock:
            self._staged.setdefault(rank, {})[key] = value

    def get(self, key: str, default: Any = PMIError) -> Any:
        with self._lock:
            if key in self._committed:
                return self._committed[key]
        if default is PMIError:
            raise PMIError(f"key {key!r} not committed in KVS {self.name!r}")
        return default

    def commit_all(self) -> None:
        """Collective fence: merge every worker's staged puts. Called by the
        barrier once all participants arrive."""
        with self._lock:
            for staged in self._staged.values():
                self._committed.update(staged)
            self._staged.clear()
            self._fence_count += 1

    @property
    def fence_count(self) -> int:
        return self._fence_count

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return dict(self._committed)


@dataclass
class WorkerInfo:
    worker_id: str
    rank: int
    generation: int
    last_heartbeat: float = field(default_factory=time.monotonic)
    alive: bool = True
    meta: dict = field(default_factory=dict)


class PMIServer:
    """The rendezvous + membership server (paper's ``pmiserv``).

    Workers register, receive a rank within the current *generation*, heartbeat
    periodically, and participate in fences. A missed-heartbeat (or explicit
    ``fail_worker``) marks the worker dead and bumps the generation; the
    elastic controller then re-forms the worker set (smaller mesh, restored
    from checkpoint) — the Spark-MPI answer to node failure at scale.
    """

    def __init__(self, world_size: int, heartbeat_timeout: float = 5.0) -> None:
        self.world_size = world_size
        self.heartbeat_timeout = heartbeat_timeout
        self._lock = threading.Condition()
        self.generation = 0
        self._workers: dict[str, WorkerInfo] = {}
        self._kvs: dict[int, KeyValueSpace] = {0: KeyValueSpace("kvs_gen0")}
        self._barrier_arrived: set[str] = set()
        self._barrier_epoch = 0

    # -- membership -------------------------------------------------------
    def register(self, worker_id: str, meta: dict | None = None) -> WorkerInfo:
        with self._lock:
            if worker_id in self._workers and self._workers[worker_id].alive:
                return self._workers[worker_id]
            rank = len([w for w in self._workers.values()
                        if w.alive and w.generation == self.generation])
            info = WorkerInfo(worker_id=worker_id, rank=rank,
                              generation=self.generation, meta=meta or {})
            self._workers[worker_id] = info
            self._lock.notify_all()
            log.debug("PMI register %s -> rank %d (gen %d)", worker_id, rank,
                      self.generation)
            return info

    def heartbeat(self, worker_id: str) -> None:
        with self._lock:
            info = self._workers.get(worker_id)
            if info is None or not info.alive:
                raise PMIError(f"heartbeat from unknown/dead worker {worker_id}")
            info.last_heartbeat = time.monotonic()

    def alive_workers(self) -> list[WorkerInfo]:
        with self._lock:
            return sorted((w for w in self._workers.values() if w.alive),
                          key=lambda w: w.rank)

    def fail_worker(self, worker_id: str) -> int:
        """Mark a worker dead; bump generation. Returns the new generation."""
        with self._lock:
            info = self._workers.get(worker_id)
            if info is None:
                raise PMIError(f"unknown worker {worker_id}")
            info.alive = False
            return self._bump_generation_locked()

    def check_heartbeats(self) -> list[str]:
        """Watchdog: expire workers with stale heartbeats. Returns failures."""
        now = time.monotonic()
        failed = []
        with self._lock:
            for info in self._workers.values():
                if info.alive and now - info.last_heartbeat > self.heartbeat_timeout:
                    info.alive = False
                    failed.append(info.worker_id)
            if failed:
                self._bump_generation_locked()
        return failed

    def _bump_generation_locked(self) -> int:
        self.generation += 1
        # Re-rank survivors densely so the new mesh has contiguous ranks.
        survivors = sorted((w for w in self._workers.values() if w.alive),
                           key=lambda w: w.rank)
        for new_rank, info in enumerate(survivors):
            info.rank = new_rank
            info.generation = self.generation
        self._kvs[self.generation] = KeyValueSpace(f"kvs_gen{self.generation}")
        self._barrier_arrived.clear()
        self._lock.notify_all()
        log.info("PMI generation -> %d (%d alive)", self.generation, len(survivors))
        return self.generation

    # -- KVS + fence --------------------------------------------------------
    def kvs(self, generation: int | None = None) -> KeyValueSpace:
        with self._lock:
            return self._kvs[self.generation if generation is None else generation]

    def fence(self, worker_id: str, timeout: float = 30.0) -> None:
        """Collective barrier + KVS commit across the current generation."""
        deadline = time.monotonic() + timeout
        with self._lock:
            gen = self.generation
            epoch = self._barrier_epoch
            self._barrier_arrived.add(worker_id)
            n_alive = len([w for w in self._workers.values() if w.alive])
            if len(self._barrier_arrived) >= n_alive:
                self._kvs[gen].commit_all()
                self._barrier_arrived.clear()
                self._barrier_epoch += 1
                self._lock.notify_all()
                return
            while self._barrier_epoch == epoch:
                if self.generation != gen:
                    raise PMIError("generation changed during fence (worker died)")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise PMIError(f"fence timeout for {worker_id}")
                self._lock.wait(timeout=min(remaining, 0.5))


class PMIClient:
    """Worker-side handle: the ``PMI_PORT``/``PMI_ID`` role from the paper."""

    def __init__(self, server: PMIServer, worker_id: str,
                 meta: dict | None = None) -> None:
        self._server = server
        self.worker_id = worker_id
        self.info = server.register(worker_id, meta)

    @property
    def rank(self) -> int:
        return self.info.rank

    @property
    def generation(self) -> int:
        return self.info.generation

    def put(self, key: str, value: Any) -> None:
        self._server.kvs(self.generation).put(self.rank, key, value)

    def get(self, key: str, default: Any = PMIError) -> Any:
        return self._server.kvs(self.generation).get(key, default)

    def fence(self, timeout: float = 30.0) -> None:
        self._server.fence(self.worker_id, timeout=timeout)

    def heartbeat(self) -> None:
        self._server.heartbeat(self.worker_id)
