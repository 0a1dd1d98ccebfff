"""Resilient Distributed Datasets, trimmed to what the streaming path uses.

The counterpart of ``repro/core/rdd.py``: partitioned, lazily evaluated
datasets, where a partition is computed (from the broker, for the RDDs of
``create_rdd``) when it is asked for. ``create_rdd`` builds one partition per
broker offset range, and each micro-batch unions the per-topic RDDs; the
§IV path re-cuts a batch with ``Context.parallelize`` and runs its sweep
with ``map_partitions``; ``Context.from_partitions`` hands the bridge one
block a rank. The reference's threaded task scheduler (retries,
speculation) and its other transformations are left out: partitions are
computed in order, in the calling thread. On one card its threads would
only queue on one stream, and a speculative copy would launch a kernel
twice.
"""
from __future__ import annotations

import bisect
import itertools
from typing import Any, Callable, Iterable, Sequence

import numpy as np


class RDD:
    """An immutable, partitioned, lazily-evaluated dataset with lineage."""

    def __init__(self, context: "Context", num_partitions: int,
                 compute: Callable[[int], Any]) -> None:
        self.context = context
        self.num_partitions = num_partitions
        self._compute = compute     # partition index -> partition data

    def compute_partition(self, idx: int) -> Any:
        return self._compute(idx)

    def map_partitions(self, fn: Callable[[Any], Any]) -> "RDD":
        """``fn`` applied to each whole partition, lazily."""
        def compute(idx: int) -> Any:
            return fn(self.compute_partition(idx))

        return RDD(self.context, self.num_partitions, compute)

    def union(self, *others: "RDD") -> "RDD":
        """Paper Fig. 8: per-topic RDDs combined with a union before the MPI
        job — partitions are concatenated."""
        rdds = (self,) + others
        starts = list(itertools.accumulate(
            (r.num_partitions for r in rdds), initial=0))

        def compute(idx: int) -> Any:
            src = bisect.bisect_right(starts, idx) - 1
            return rdds[src].compute_partition(idx - starts[src])

        return RDD(self.context, starts[-1], compute)

    def collect_partitions(self) -> list[Any]:
        return [self.compute_partition(p) for p in range(self.num_partitions)]

    def collect(self) -> list[Any]:
        """Every partition, gathered in order and flattened."""
        out: list[Any] = []
        for part in self.collect_partitions():
            out.extend(part if isinstance(part, list) else [part])
        return out


class Context:
    """The SparkContext analogue. The reference's owns a threaded task
    scheduler; here partitions run in the calling thread, so it holds
    nothing, and it stays so that RDDs are made as the reference makes
    them."""

    def parallelize(self, data: Iterable[Any], num_partitions: int) -> RDD:
        """An RDD of ``data`` cut into ``num_partitions`` contiguous slices,
        as Spark (and the reference) cuts it."""
        items = list(data)
        if num_partitions <= 0:
            raise ValueError("num_partitions must be positive")
        bounds = np.linspace(0, len(items), num_partitions + 1).astype(int)

        def compute(idx: int) -> list[Any]:
            return items[bounds[idx]:bounds[idx + 1]]

        return RDD(self, num_partitions, compute)

    def from_partitions(self, partitions: Sequence[Any]) -> RDD:
        """An RDD whose partition ``i`` is ``partitions[i]``: the data plane
        side of the bridge (``TorchBridge.to_rdd``, and one block a rank
        for ``TorchBridge.run``)."""
        parts = list(partitions)

        def compute(idx: int) -> Any:
            return parts[idx]

        return RDD(self, len(parts), compute)
