"""The Spark<->MPI bridge: the paper's contribution, on ``torch.distributed``.

The counterpart of ``repro/core/bridge.py:MPIBridge`` (paper Fig. 1): the
workers that hold RDD partitions flip into ranks and run a collective
program in place, with no round trip through the driver. A bridge's ranks
are its *local ranks* times the ranks of its process ``group``:

* local ranks are a tuple of devices in this process (repeats allowed),
  the counterpart of the reference's mesh of virtual devices in one
  process; the elastic controller's worker slots on one card are these;
* the group's ranks are other processes, on NCCL on the card or gloo on
  the CPU, the counterpart of a multi-host mesh.

Rank ``r`` is local rank ``r % L`` of group rank ``r // L`` (``L`` local
ranks a process), and partition ``r`` of an RDD goes to rank ``r``; a
process computes only its own partitions. The paths of the paper's Table I:

* :meth:`TorchBridge.allreduce` (and :meth:`TorchBridge.run` with any
  ``torch.distributed`` collective on ``bridge.group``): the Spark-MPI
  path. The local ranks' partitions reduce in rank order on the device,
  then across the group;
* :meth:`TorchBridge.driver_reduce`: the driver-worker path, every
  partition funnelled through the host;
* ``allreduce(..., compression="int8")``: the compressed all-reduce of
  ``optim/compression.py``.

Before the first collective, every rank puts its coordinates (its device)
into the PMI key-value space and the KVS is committed once, as in the
reference; with a group the coordinates are first gathered from every
process, so each process's KVS holds all of them.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.pmi import PMIClient, PMIServer
from repro_torch.core.rdd import RDD, Context
from repro_torch.optim.compression import compressed_sum
from repro_torch.utils import resolve_device, tree_map

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "mean": dist.ReduceOp.SUM}


def make_worker_mesh(device_type: str = "cuda",
                     axis_name: str = "workers"):
    """A 1-D ``DeviceMesh`` named ``axis_name`` over every process of the
    default process group, the counterpart of the reference's
    ``make_worker_mesh`` over its devices (``repro/core/bridge.py:45``).
    A mesh spans processes here, so the group must be made first."""
    if not dist.is_initialized():
        raise ValueError("make_worker_mesh: a mesh spans the processes of "
                         "torch.distributed's default group; make it first "
                         "(a group of one process is world 1)")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


class TorchBridge:
    """Runs collective programs over RDD partitions on the local ranks
    ``devices`` of this process and the processes of ``group``.

    ``TorchBridge(device=d)`` is one rank on ``d``; without a device or
    devices the one rank is on the CUDA device."""

    def __init__(self, device: str | torch.device | None = None, *,
                 devices: Sequence[str | torch.device] | None = None,
                 group: Any = None) -> None:
        if devices is None:
            devices = [resolve_device("cuda" if device is None else device)]
        elif device is not None:
            raise ValueError("pass device or devices, not both")
        if not devices:
            raise ValueError("a bridge needs at least one local rank")
        self.devices = tuple(resolve_device(d) for d in devices)
        self.device = self.devices[0]
        self.group = group
        self.local_world = len(self.devices)
        self.group_rank = dist.get_rank(group) if group is not None else 0
        self.group_world = (dist.get_world_size(group) if group is not None
                            else 1)
        self.world = self.local_world * self.group_world
        self.ranks = range(self.group_rank * self.local_world,
                           (self.group_rank + 1) * self.local_world)
        # PMI wire-up: every rank publishes its coordinates, then the KVS
        # is committed once (all ranks are known here: no threaded fence)
        coords = [str(d) for d in self.devices]
        if group is not None:
            gathered: list[Any] = [None] * self.group_world
            dist.all_gather_object(gathered, coords, group=group)
            coords = [c for proc in gathered for c in proc]
        self.pmi = PMIServer(world_size=self.world)
        self._clients = [PMIClient(self.pmi, f"worker-{r}")
                         for r in range(self.world)]
        for c in self._clients:
            c.put(f"coords/{c.rank}", coords[c.rank])
        self.pmi.kvs().commit_all()

    # -- data plane -> compute plane ------------------------------------------
    def _local_blocks(self, rdd: RDD) -> list[Any]:
        """This process's partitions, one a local rank, as tensors on the
        rank's device: partition r -> rank r."""
        if rdd.num_partitions != self.world:
            raise ValueError(
                f"RDD has {rdd.num_partitions} partitions but bridge world "
                f"is {self.world}; repartition first (paper: one rank per "
                "worker)")
        return [tree_map(lambda x, d=dev: torch.as_tensor(x).to(d),
                         rdd.compute_partition(r))
                for r, dev in zip(self.ranks, self.devices)]

    def to_rdd(self, context: Context, tree: Any) -> RDD:
        """Compute plane -> data plane: the leading axis (one block a local
        rank) split back into partitions, on the host."""
        def part(i: int) -> Any:
            return tree_map(lambda x: x[i].detach().cpu().numpy(), tree)

        lead = {x.shape[0] for x in _leaves(tree)}
        if lead != {self.local_world}:
            raise ValueError(f"leading axes {sorted(lead)} != the "
                             f"{self.local_world} local ranks")
        return context.from_partitions([part(i)
                                        for i in range(self.local_world)])

    # -- collective programs -------------------------------------------------
    def spmd(self, fn: Callable[..., Any]) -> Callable[..., Any]:
        """``fn`` as this process's rank of a collective program: it sees
        its rank's block (leading axis 1) and may call any
        ``torch.distributed`` collective on ``bridge.group``."""
        if self.local_world != 1:
            raise ValueError(
                f"a collective program needs one process a rank; this "
                f"bridge holds {self.local_world} local ranks")
        return fn

    def run(self, rdd: RDD, fn: Callable[..., Any]) -> Any:
        """Run ``fn`` on this rank's partition, stacked to a leading axis
        of 1. Returns this rank's output (the reference returns every
        rank's, stacked; a process here holds its own)."""
        program = self.spmd(fn)
        (block,) = self._local_blocks(rdd)
        return program(tree_map(lambda x: x[None], block))

    def allreduce(self, rdd: RDD, op: str = "sum",
                  compression: str | None = None) -> Any:
        """Paper Fig. 6 ``allreduce.py``: the partitions reduced in place
        across the ranks. Every rank ends with the same value; this returns
        rank 0's copy, on the bridge's device. With ``compression="int8"``
        the reduction is a sum whatever ``op`` says, as the reference's."""
        if compression not in (None, "int8"):
            raise ValueError(f"unknown compression {compression!r}")
        if op not in _OPS:
            raise ValueError(f"unknown op {op!r}")
        blocks = self._local_blocks(rdd)
        return tree_map(lambda *xs: self._reduce(xs, op, compression),
                        *blocks)

    def _reduce(self, xs: Sequence[torch.Tensor], op: str,
                compression: str | None) -> torch.Tensor:
        if compression == "int8":
            return compressed_sum(xs, self.group)
        acc = xs[0].to(self.device, copy=True)
        for x in xs[1:]:
            x = x.to(self.device)
            if op == "max":
                torch.maximum(acc, x, out=acc)
            else:
                acc += x
        if self.group is not None:
            dist.all_reduce(acc, op=_OPS[op], group=self.group)
        if op == "mean":
            acc /= self.world
        return acc

    # -- the slow path (Table I baseline) ------------------------------------
    @staticmethod
    def driver_reduce(rdd: RDD, op: str = "sum") -> Any:
        """Paper Fig. 5 ``collect.py``: every partition gathered to the
        driver and summed there, on the host: the path Table I shows losing
        by 100x."""
        if op != "sum":
            raise ValueError("driver_reduce benchmark implements sum")
        arrays = [tree_map(_host, p) for p in rdd.collect_partitions()]
        acc = arrays[0]
        for a in arrays[1:]:
            acc = tree_map(np.add, acc, a)
        return acc


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _leaves(tree: Any) -> list[Any]:
    out: list[Any] = []
    tree_map(out.append, tree)
    return out


def rank_of(group: Any = None) -> int:
    """MPI_Comm_rank inside a collective program: this process's rank in
    ``group`` (0 without one)."""
    return dist.get_rank(group) if group is not None else 0


def world_of(group: Any = None) -> int:
    """MPI_Comm_size: the processes of ``group`` (1 without one)."""
    return dist.get_world_size(group) if group is not None else 1
