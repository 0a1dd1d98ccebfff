"""Resilient Distributed Datasets — the Spark middleware layer, in-process.

The counterpart of ``repro/core/rdd.py``, with the three RDD properties the
paper leans on:

1. **Partitioned, lazily-evaluated datasets** with narrow (map, filter, zip,
   union) and wide (repartition) dependencies — :class:`RDD`. A partition
   is computed (from the broker, for the RDDs of ``create_rdd``) when it is
   asked for.
2. **Lineage-based fault tolerance**: a lost partition is *recomputed* from
   its parents instead of being replicated. :class:`TaskScheduler` retries
   a failed task by running it again, which replays its lineage (a broker
   read re-reads the same offsets), and :class:`FailureInjector` makes
   tests and ``chip_smoke.py`` lose partitions on purpose.
3. **The driver–worker execution model**: the driver builds the DAG, the
   scheduler runs partition tasks on a pool of executor threads, and
   ``collect()`` funnels every partition back through the driver (the
   paper's Table I slow path; ``core/bridge.py`` is the fast path).

The scheduler does what matters at scale regardless of transport: bounded
retries driven by lineage, and speculative re-execution of stragglers. On
one card its executors' kernel launches go to the device's current stream,
which every thread shares, so they run one after another, as the
reference's threads do on one TPU.

One repair over the reference (ROADMAP Queue 3): when a job ends with no
attempt still running, :meth:`TaskScheduler.run` waits for its idle pool
threads to exit, so none outlives the job; a straggler twin still running
is abandoned without waiting, as the reference abandons it.
"""
from __future__ import annotations

import bisect
import itertools
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Sequence

import numpy as np

from repro_torch.data.locktrace import new_lock
from repro_torch.data.metrics import Span, current_span, span
from repro_torch.utils import get_logger

log = get_logger(__name__)

_rdd_ids = itertools.count()


class PartitionLostError(RuntimeError):
    """Raised by failure injection / executors when a partition's cached or
    computed data is lost; the scheduler recomputes it from lineage."""


@dataclass(frozen=True)
class TaskAttempt:
    rdd_id: int
    partition: int
    attempt: int
    speculative: bool = False


class FailureInjector:
    """Deterministic fault injection for tests and the card's smoke run.

    ``fail[p] = n`` makes the first ``n`` attempts at partition index ``p``
    raise :class:`PartitionLostError`; ``slow[p] = s`` makes every attempt
    at ``p`` that is not speculative sleep ``s`` seconds first (a
    straggler). Attempts are counted by partition index across every RDD
    the scheduler runs, as the reference counts them."""

    def __init__(self,
                 fail: dict[int, int] | None = None,
                 slow: dict[int, float] | None = None) -> None:
        self.fail = dict(fail or {})
        self.slow = dict(slow or {})
        self._lock = new_lock("FailureInjector._lock")
        self._attempts: dict[int, int] = {}

    def on_task(self, attempt: TaskAttempt) -> None:
        with self._lock:
            n = self._attempts.get(attempt.partition, 0)
            self._attempts[attempt.partition] = n + 1
        delay = self.slow.get(attempt.partition)
        if delay and not attempt.speculative:
            time.sleep(delay)
        if self.fail.get(attempt.partition, 0) > n:
            raise PartitionLostError(
                f"injected loss of partition {attempt.partition} "
                f"(attempt {attempt.attempt})")


class RDD:
    """An immutable, partitioned, lazily-evaluated dataset with lineage."""

    def __init__(self, context: "Context", num_partitions: int,
                 parents: Sequence["RDD"],
                 compute: Callable[[int], Any],
                 name: str = "rdd") -> None:
        self.context = context
        self.id = next(_rdd_ids)
        self.num_partitions = num_partitions
        self.parents = tuple(parents)
        self._compute = compute     # partition index -> partition data
        self.name = name
        self._cache: dict[int, Any] = {}
        self._cached = False

    # -- lineage ----------------------------------------------------------------
    def compute_partition(self, idx: int) -> Any:
        """Partition ``idx``, from the cache when it holds it, else computed
        from lineage."""
        if idx in self._cache:
            return self._cache[idx]
        data = self._compute(idx)
        if self._cached:
            self._cache[idx] = data
        return data

    def cache(self) -> "RDD":
        self._cached = True
        return self

    def unpersist_partition(self, idx: int) -> None:
        """Lose a cached partition (a node's crash): the next use recomputes
        it from lineage."""
        self._cache.pop(idx, None)

    def lineage(self) -> list["RDD"]:
        """Topologically-ordered ancestry (self last)."""
        seen: dict[int, RDD] = {}

        def visit(r: RDD) -> None:
            if r.id in seen:
                return
            for p in r.parents:
                visit(p)
            seen[r.id] = r

        visit(self)
        return list(seen.values())

    # -- narrow transformations ---------------------------------------------------
    def map(self, fn: Callable[[Any], Any]) -> "RDD":
        """``fn`` over each element of a list partition, or over the whole
        partition when it is not a list."""
        def compute(idx: int) -> Any:
            part = self.compute_partition(idx)
            if isinstance(part, list):
                return [fn(x) for x in part]
            return fn(part)

        return RDD(self.context, self.num_partitions, [self], compute,
                   name=f"{self.name}.map")

    def map_partitions(self, fn: Callable[[Any], Any]) -> "RDD":
        """``fn`` applied to each whole partition, lazily."""
        def compute(idx: int) -> Any:
            return fn(self.compute_partition(idx))

        return RDD(self.context, self.num_partitions, [self], compute,
                   name=f"{self.name}.mapPartitions")

    def map_partitions_with_index(self, fn: Callable[[int, Any], Any]
                                  ) -> "RDD":
        def compute(idx: int) -> Any:
            return fn(idx, self.compute_partition(idx))

        return RDD(self.context, self.num_partitions, [self], compute,
                   name=f"{self.name}.mapPartitionsWithIndex")

    def filter(self, pred: Callable[[Any], bool]) -> "RDD":
        def compute(idx: int) -> Any:
            part = self.compute_partition(idx)
            items = part if isinstance(part, list) else [part]
            return [x for x in items if pred(x)]

        return RDD(self.context, self.num_partitions, [self], compute,
                   name=f"{self.name}.filter")

    def zip_partitions(self, other: "RDD",
                       fn: Callable[[Any, Any], Any]) -> "RDD":
        if other.num_partitions != self.num_partitions:
            raise ValueError("zip requires equal partition counts")

        def compute(idx: int) -> Any:
            return fn(self.compute_partition(idx),
                      other.compute_partition(idx))

        return RDD(self.context, self.num_partitions, [self, other], compute,
                   name=f"{self.name}.zip")

    def union(self, *others: "RDD") -> "RDD":
        """Paper Fig. 8: per-topic RDDs combined with a union before the MPI
        job — partitions are concatenated, lineage fans in."""
        rdds = (self,) + others
        starts = list(itertools.accumulate(
            (r.num_partitions for r in rdds), initial=0))

        def compute(idx: int) -> Any:
            src = bisect.bisect_right(starts, idx) - 1
            return rdds[src].compute_partition(idx - starts[src])

        return RDD(self.context, starts[-1], list(rdds), compute,
                   name=f"{self.name}.union")

    # -- wide transformation ------------------------------------------------------
    def repartition(self, num_partitions: int) -> "RDD":
        """Wide dependency: every output partition reads all input
        partitions, and takes every ``num_partitions``-th element."""
        def compute(idx: int) -> Any:
            items: list[Any] = []
            for p in range(self.num_partitions):
                part = self.compute_partition(p)
                items.extend(part if isinstance(part, list) else [part])
            return items[idx::num_partitions]

        return RDD(self.context, num_partitions, [self], compute,
                   name=f"{self.name}.repartition")

    # -- actions --------------------------------------------------------------------
    def collect_partitions(self) -> list[Any]:
        """Every partition, through the context's scheduler, in order."""
        return self.context.scheduler.run(self)

    def collect(self) -> list[Any]:
        """Every partition, gathered to the driver in order and flattened."""
        out: list[Any] = []
        for part in self.collect_partitions():
            out.extend(part if isinstance(part, list) else [part])
        return out

    def count(self) -> int:
        return len(self.collect())

    def reduce(self, fn: Callable[[Any, Any], Any]) -> Any:
        items = self.collect()
        if not items:
            raise ValueError("reduce of empty RDD")
        acc = items[0]
        for x in items[1:]:
            acc = fn(acc, x)
        return acc

    def take(self, n: int) -> list[Any]:
        return self.collect()[:n]


class TaskScheduler:
    """Runs partition tasks on executor threads, with lineage-driven retries
    and speculation.

    * Retry: a task failing with any exception is re-run until its
      partition has had ``max_failures`` + 1 attempts; because RDDs are lazy
      and deterministic, the re-run *is* the lineage recompute.
    * Straggler mitigation: once ``speculation_quantile`` of the tasks have
      finished, a task running longer than ``speculation_multiplier`` × the
      median finished task's time (and at least 0.05 s) gets one
      speculative copy; the first result wins — Spark's speculative
      execution.

    ``metrics`` counts ``tasks`` (attempts started), ``retries``,
    ``speculative`` copies and ``speculative_wins``, over every job run.
    Each attempt is the span ``task`` (its partition, attempt and whether
    it is speculative), from an executor's pick-up to its result, a child
    of the span that ran the job, so of its micro-batch."""

    def __init__(self, num_executors: int = 4, max_failures: int = 4,
                 speculation: bool = True, speculation_multiplier: float = 4.0,
                 speculation_quantile: float = 0.5,
                 failure_injector: FailureInjector | None = None) -> None:
        self.num_executors = num_executors
        self.max_failures = max_failures
        self.speculation = speculation
        self.speculation_multiplier = speculation_multiplier
        self.speculation_quantile = speculation_quantile
        self.failure_injector = failure_injector
        self.metrics = {"tasks": 0, "retries": 0, "speculative": 0,
                        "speculative_wins": 0}
        # executors count their tasks, the driver thread the rest
        self._lock = new_lock("TaskScheduler._lock")

    def _count(self, metric: str) -> None:
        with self._lock:
            self.metrics[metric] += 1

    def _run_task(self, rdd: RDD, attempt: TaskAttempt,
                  parent: Span | None = None) -> Any:
        with span("task", parent=parent,
                  attrs={"partition": attempt.partition,
                         "attempt": attempt.attempt,
                         "speculative": attempt.speculative}):
            self._count("tasks")
            if self.failure_injector is not None:
                self.failure_injector.on_task(attempt)
            return rdd.compute_partition(attempt.partition)

    def run(self, rdd: RDD) -> list[Any]:
        """Every partition of ``rdd``, in order. Raises ``RuntimeError``
        when a partition fails more than ``max_failures`` times."""
        n = rdd.num_partitions
        results: dict[int, Any] = {}
        attempts: dict[int, int] = {p: 0 for p in range(n)}
        durations: list[float] = []
        running: dict[Future, tuple[TaskAttempt, float]] = {}
        parent = current_span()        # each task's span joins the caller's

        pool = ThreadPoolExecutor(max_workers=self.num_executors)
        try:
            def launch(p: int, speculative: bool = False) -> None:
                att = TaskAttempt(rdd.id, p, attempts[p], speculative)
                attempts[p] += 1
                fut = pool.submit(self._run_task, rdd, att, parent)
                running[fut] = (att, time.monotonic())
                if speculative:
                    self._count("speculative")

            for p in range(n):
                launch(p)

            while len(results) < n:
                done, _ = wait(list(running), timeout=0.05,
                               return_when=FIRST_COMPLETED)
                now = time.monotonic()
                for fut in done:
                    att, t0 = running.pop(fut)
                    if att.partition in results:
                        continue  # a twin already finished
                    try:
                        results[att.partition] = fut.result()
                        durations.append(now - t0)
                        if att.speculative:
                            self._count("speculative_wins")
                    except Exception as exc:  # the lineage recompute path
                        if attempts[att.partition] > self.max_failures:
                            raise RuntimeError(
                                f"partition {att.partition} of {rdd.name} "
                                f"failed {attempts[att.partition]} times"
                            ) from exc
                        self._count("retries")
                        log.debug("retrying partition %d of %s: %s",
                                  att.partition, rdd.name, exc)
                        launch(att.partition)
                # speculative re-execution of stragglers
                if (self.speculation and durations
                        and len(durations) >= self.speculation_quantile * n):
                    median = float(np.median(durations))
                    threshold = max(self.speculation_multiplier * median, 0.05)
                    for att, t0 in list(running.values()):
                        p = att.partition
                        if (p not in results and now - t0 > threshold
                                and sum(1 for a, _ in running.values()
                                        if a.partition == p) == 1):
                            launch(p, speculative=True)
        finally:
            # a twin still queued never starts; a straggler twin still
            # running must not block the job, so the pool is abandoned to
            # it; with none running, the idle threads are joined here
            for fut in running:
                fut.cancel()
            pool.shutdown(wait=all(fut.done() for fut in running),
                          cancel_futures=True)
        return [results[p] for p in range(n)]


class Context:
    """The SparkContext analogue: owns the scheduler, builds source RDDs.
    By default a :class:`TaskScheduler` of ``num_executors`` threads, as
    the reference's."""

    def __init__(self, num_executors: int = 4,
                 scheduler: TaskScheduler | None = None) -> None:
        self.scheduler = scheduler or TaskScheduler(
            num_executors=num_executors)

    def parallelize(self, data: Iterable[Any], num_partitions: int) -> RDD:
        """An RDD of ``data`` cut into ``num_partitions`` contiguous slices,
        as Spark (and the reference) cuts it."""
        items = list(data)
        if num_partitions <= 0:
            raise ValueError("num_partitions must be positive")
        bounds = np.linspace(0, len(items), num_partitions + 1).astype(int)

        def compute(idx: int) -> list[Any]:
            return items[bounds[idx]:bounds[idx + 1]]

        return RDD(self, num_partitions, [], compute, name="parallelize")

    def from_partitions(self, partitions: Sequence[Any]) -> RDD:
        """An RDD whose partition ``i`` is ``partitions[i]``: the data plane
        side of the bridge (``TorchBridge.to_rdd``, and one block a rank
        for ``TorchBridge.run``)."""
        parts = list(partitions)

        def compute(idx: int) -> Any:
            return parts[idx]

        return RDD(self, len(parts), [], compute, name="fromPartitions")

    def union(self, rdds: Sequence[RDD]) -> RDD:
        first, *rest = rdds
        return first.union(*rest)
