"""Per-card cost of one rank's step, counted from the operations it
dispatches: the job of ``repro/launch/hlocost.py``.

The reference walks the optimized HLO of a compiled step, multiplying
each ``while`` body by its trip count. The port has no HLO: an eager step
dispatches every operation of every trip, so :class:`OpCost`, a
``TorchDispatchMode``, sees the whole step as it runs, on real tensors or
on fake ones (``FakeTensorMode``), and counts for this rank:

  * flops            — products only, as ``_dot_flops`` counts them:
                       ``mm``, ``addmm``, ``bmm``, ``baddbmm`` (whatever
                       ``matmul``, ``linear`` and ``einsum`` decompose
                       into), ``mv``/``addmv``/``dot``, and the flash
                       operator by its formula; a convolution as
                       2·|output|, as the reference counts one;
  * transcendentals  — the reference's ``_TRANSCENDENTAL_OPS`` by output
                       elements (softmax and logsumexp, one exponential
                       an input element, by input elements);
  * bytes            — the input bytes plus the output bytes of every
                       operation that is not a view (a broadcast
                       dimension read once): the reference's
                       fusion-boundary model, exact here since each eager
                       operation is its own kernel. A gather reads only
                       the rows it returns and an in-place scatter writes
                       only its values, as the reference's slice and
                       update-slice rules read them; allocations without
                       data and storage-sharing reshapes move nothing;
  * collective wire bytes per card by the reference's formulas
    (``_collective_bytes``): all-reduce 2·b·(n−1)/n, all-gather,
    reduce-scatter and all-to-all b·(n−1)/n, send and recv b (a
    broadcast, which the reference has no counterpart of, b), with n and
    the ranks read from the process group, for DTensor's functional
    collectives and for the ``c10d`` ones that ``parallel/dp.py``,
    ``models/moe.py`` and ``parallel/pp.py`` call. A group inside one
    node of ``GPUS_PER_NODE`` cards counts as ``nvlink_bytes``, one that
    spans nodes (a send to another node's card) as ``network_bytes``:
    the node is the H100's fabric boundary, where the reference splits
    at the pod.

A DTensor operation is left to DTensor, so the walker counts the local
operations and the collectives it runs for it: one rank's work. The
operations DTensor runs on fake global-shape tensors to choose a sharding
and learn an output's shape (its sharding propagation) are no work of
the step and are not counted.

``while_breakdown``'s job, which loop owns each term, is done by scopes:
the model marks each layer, its attention and MLP or experts, each CE
chunk and the optimizer with a cost scope of the span log
(``data/metrics.py``: ``cost_scope``, and the optimizer's span), which
calls the walkers registered with ``metrics.add_listener``, and every
operation is filed under the scopes open when it ran. A backward
operation is filed under the scope of the forward operation whose node
it runs ('.../backward'), found by autograd's sequence numbers, and the
recompute of a checkpointed layer under that layer ('<layer>/recompute').

With ``memory=True`` it also follows every storage an operation returns
until it is freed (rounded as the caching allocator rounds a CUDA block),
with the tensors passed to :meth:`OpCost.track` live from the start, and
keeps the peak and the scope that reached it: the dry-run's peak
memory.
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import utils
from repro_torch.data import metrics
from repro_torch.launch.mesh import GPUS_PER_NODE

# the allocator's smallest block on a CUDA device
_CUDA_BLOCK = 512

_DOTS = {"mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot"}
_TRANSCENDENTAL = {"exp", "exp_", "exp2", "log", "log_", "log2", "log1p",
                   "tanh", "tanh_", "rsqrt", "rsqrt_", "sqrt", "sqrt_",
                   "pow", "pow_", "cos", "cos_", "sin", "sin_", "sigmoid",
                   "sigmoid_", "expm1", "silu", "silu_"}
_TRANSCENDENTAL_BY_INPUT = {"_softmax", "_log_softmax", "logsumexp"}
# reads only the rows it returns: the data operand costs the output's bytes
_GATHERS = {"embedding", "index_select", "gather", "index"}
# writes only its values into the destination, in place
_SCATTERS = {"index_put_", "_index_put_impl_", "index_copy_", "scatter_",
             "scatter_add_", "index_add_"}
# no data moved: allocations, reshapes that share a storage, lifted
# constants, metadata
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "_unsafe_view", "lift_fresh",
               "resize_", "set_", "_local_scalar_dense"}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
# op name -> (kind, which bytes b the formula takes: 'in' or 'out')
_COLLECTIVES = {
    "allreduce_": ("all_reduce", "in"),
    "allreduce_coalesced_": ("all_reduce", "in"),
    "all_reduce": ("all_reduce", "in"),
    "all_reduce_": ("all_reduce", "in"),
    "all_reduce_coalesced": ("all_reduce", "in"),
    "all_reduce_coalesced_": ("all_reduce", "in"),
    "allgather_": ("all_gather", "out"),
    "_allgather_base_": ("all_gather", "out"),
    "allgather_into_tensor_coalesced_": ("all_gather", "out"),
    "all_gather_into_tensor": ("all_gather", "out"),
    "all_gather_into_tensor_out": ("all_gather", "out"),
    "all_gather_into_tensor_coalesced": ("all_gather", "out"),
    "reduce_scatter_": ("reduce_scatter", "in"),
    "_reduce_scatter_base_": ("reduce_scatter", "in"),
    "reduce_scatter_tensor_coalesced_": ("reduce_scatter", "in"),
    "reduce_scatter_tensor": ("reduce_scatter", "in"),
    "reduce_scatter_tensor_coalesced": ("reduce_scatter", "in"),
    "alltoall_": ("all_to_all", "in"),
    "alltoall_base_": ("all_to_all", "in"),
    "all_to_all_single": ("all_to_all", "in"),
    "send": ("send", "in"),
    "recv_": ("recv", "in"),
    "recv_any_source_": ("recv", "in"),
    "broadcast_": ("broadcast", "in"),
    "broadcast": ("broadcast", "in"),
}
# outputs of these are lists or tensors the collective writes in place
_IN_PLACE_OUTPUT = {"allreduce_", "allreduce_coalesced_", "all_reduce_",
                    "broadcast_", "recv_", "recv_any_source_"}


# DTensor's sharding propagation runs operations of its own on fake
# tensors of the global shape, to learn an output's shape and to choose a
# strategy by decomposing an operation; while it does, nothing counts.
# [depth, whether every function below is wrapped]
_PROPAGATING = [0, False]
_PROPAGATION = ("propagate_op_sharding_non_cached",
                "_propagate_tensor_meta_non_cached")


def _mute_propagation() -> None:
    """Wrap DTensor's sharding propagation so that the walker can tell its
    operations from the step's; installed once, on the first walker."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    wrapped = 0
    for name in _PROPAGATION:
        fn = getattr(ShardingPropagator, name, None)
        if fn is None:
            continue
        wrapped += 1
        if getattr(fn, "_repro_muted", False):
            continue

        def muted(self: Any, *args: Any, _fn: Any = fn, **kwargs: Any
                  ) -> Any:
            _PROPAGATING[0] += 1
            try:
                return _fn(self, *args, **kwargs)
            finally:
                _PROPAGATING[0] -= 1
        muted._repro_muted = True
        setattr(ShardingPropagator, name, muted)
    _PROPAGATING[1] = wrapped == len(_PROPAGATION)


def _propagating() -> bool:
    """Inside DTensor's sharding propagation: by the wrappers, or, where
    this torch names its functions otherwise, by the Python stack."""
    if _PROPAGATING[0] or _PROPAGATING[1]:
        return bool(_PROPAGATING[0])
    import sys
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.startswith(("_propagate_tensor_meta",
                                        "propagate_op_sharding")):
            return True
        f = f.f_back
    return False


def _tensors(x: Any) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _addressed(t: torch.Tensor) -> int:
    """The bytes a tensor addresses: a broadcast (stride-0) dimension is
    read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _nbytes(x: Any) -> int:
    return sum(_addressed(t) for t in _tensors(x))


def _numel(x: Any) -> int:
    return sum(t.numel() for t in _tensors(x))


_VIEW_CACHE: dict = {}


def _is_view(func: Any) -> bool:
    """An operation whose schema returns an alias of an input it does not
    write: a view, no data moved."""
    got = _VIEW_CACHE.get(func)
    if got is None:
        got = any(a.alias_info is not None and not a.alias_info.is_write
                  for a in func._schema.arguments)
        _VIEW_CACHE[func] = got
    return got


def _dot_flops(name: str, args: tuple, out: Any) -> float:
    """2·|output|·K, K the contracted length, from the operand that
    carries it."""
    if name in ("addmm", "baddbmm", "addmv"):
        a = args[1]
    else:
        a = args[0]
    k = a.shape[-1] if name != "dot" else a.shape[0]
    return 2.0 * _numel(out) * k


def _group(args: tuple) -> Any:
    """The process group of a collective's arguments: a ``c10d`` op's
    ScriptObject, a functional op's group name (its last string)."""
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a)
            except RuntimeError:
                continue                 # a ReduceOp or options
    names = [a for a in args if isinstance(a, str)]
    if names:
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(names[-1])
    return None


@dataclass
class Cost:
    """One rank's counted work; ``as_dict`` is the reference's per-chip
    cost dict with ``nvlink_bytes`` and ``network_bytes`` for its
    ``ici_bytes`` and ``dcn_bytes``, and the operations counted and the
    calls of the port's kernel operators (``repro_torch::*``) beside
    it."""
    flops: float = 0.0
    bytes: float = 0.0
    nvlink_bytes: float = 0.0
    network_bytes: float = 0.0
    transcendentals: float = 0.0
    ops: int = 0
    collectives: dict = field(default_factory=dict)
    kernel_calls: dict = field(default_factory=dict)

    def add(self, other: "Cost") -> None:
        self.flops += other.flops
        self.bytes += other.bytes
        self.nvlink_bytes += other.nvlink_bytes
        self.network_bytes += other.network_bytes
        self.transcendentals += other.transcendentals
        self.ops += other.ops
        for k, v in other.collectives.items():
            self.collectives[k] = self.collectives.get(k, 0.0) + v
        for k, v in other.kernel_calls.items():
            self.kernel_calls[k] = self.kernel_calls.get(k, 0) + v

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "nvlink_bytes": self.nvlink_bytes,
                "network_bytes": self.network_bytes,
                "transcendentals": self.transcendentals, "ops": self.ops,
                "collectives": dict(self.collectives),
                "kernel_calls": dict(self.kernel_calls)}


class OpCost(TorchDispatchMode):
    """Counts one rank's step while entered (see the module docstring).
    ``rows=True`` keeps one row an operation (its scope, name and counts)
    in ``self.rows``; ``memory=True`` follows the live storages and their
    peak."""

    def __init__(self, *, node_size: int = GPUS_PER_NODE, rows: bool = False,
                 memory: bool = False) -> None:
        super().__init__()
        self.node_size = node_size
        self.cost = Cost()
        self.by_scope: dict[str, Cost] = {}
        self.rows: list[dict] | None = [] if rows else None
        self._stack: list[str] = []
        self._open: list[int] = []          # forward scopes' first seq nr
        self._recompute = 0                 # scopes opened in backward
        self._intervals: list[tuple[int, int, str]] = []
        self._seq_scope: dict[int, str] = {}
        self.memory = memory
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_scope = ""                # where the peak was reached
        self._storages: dict[int, tuple[Any, int]] = {}
        self._seq_nr = getattr(torch._C._autograd, "_get_sequence_nr", None)
        self._node = getattr(torch._C, "_current_autograd_node", None)

    # -- entering ---------------------------------------------------------------
    def __enter__(self) -> "OpCost":
        _mute_propagation()
        super().__enter__()
        metrics.add_listener(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        metrics.remove_listener(self)
        super().__exit__(*exc)

    # -- scopes -----------------------------------------------------------------
    def _in_backward(self) -> Any:
        return self._node() if self._node is not None else None

    def enter_scope(self, name: str) -> None:
        self._stack.append(name)
        if self._in_backward() is not None:
            self._recompute += 1
            self._open.append(-1)
        else:
            self._open.append(self._seq_nr() if self._seq_nr else -1)

    def exit_scope(self, name: str) -> None:
        start = self._open.pop()
        path = "/".join(self._stack)
        self._stack.pop()
        if start < 0:
            self._recompute = max(0, self._recompute - 1)
        elif self._seq_nr is not None:
            end = self._seq_nr()
            if end > start:
                self._intervals.append((start, end, path))

    def _forward_scope(self, seq: int) -> str:
        """The innermost forward scope whose operations made node ``seq``."""
        got = self._seq_scope.get(seq)
        if got is None:
            best = None
            for start, end, path in self._intervals:
                if start <= seq < end and (best is None or start > best[0]
                                           or (start == best[0]
                                               and end < best[1])):
                    best = (start, end, path)
            got = best[2] if best else ""
            self._seq_scope[seq] = got
        return got

    def scope(self) -> str:
        node = self._in_backward()
        if node is None:
            return "/".join(self._stack) or "step"
        fwd = self._forward_scope(node._sequence_nr())
        if self._recompute:
            return (fwd.split("/")[0] + "/recompute") if fwd else "recompute"
        return (fwd + "/backward") if fwd else "backward"

    # -- memory -----------------------------------------------------------------
    def _block(self, t: torch.Tensor, nbytes: int) -> int:
        if t.device.type == "cuda":
            return max(1, math.ceil(nbytes / _CUDA_BLOCK)) * _CUDA_BLOCK \
                if nbytes else 0
        return nbytes

    def _freed(self, key: int, _ref: Any) -> None:
        entry = self._storages.pop(key, None)
        if entry is not None:
            self.live_bytes -= entry[1]

    def _follow(self, tensors: list[torch.Tensor]) -> None:
        for t in tensors:
            if t.device.type == "meta":
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            size = self._block(t, st.nbytes())
            ref = weakref.ref(st, lambda r, k=key: self._freed(k, r))
            self._storages[key] = (ref, size)
            self.live_bytes += size
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            self.peak_scope = self.scope()

    def track(self, tree: Any) -> int:
        """Count the storages of ``tree``'s tensors (a DTensor's local
        block) as live from now; returns their bytes."""
        from repro_torch.parallel.sharding import is_dtensor
        leaves = [t.to_local() if is_dtensor(t) else t
                  for t in utils.tree_leaves(tree)
                  if isinstance(t, torch.Tensor)]
        before = self.live_bytes
        self._follow(leaves)
        return self.live_bytes - before

    # -- counting ---------------------------------------------------------------
    def __torch_dispatch__(self, func: Any, types: tuple, args: tuple = (),
                           kwargs: dict | None = None) -> Any:
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs it as local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _propagating():
            return out
        self._count(func, args, kwargs, out)
        if self.memory:
            self._follow(_tensors(out))
        return out

    def _count(self, func: Any, args: tuple, kwargs: dict, out: Any) -> None:
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns == "prim" or name in _NO_TRAFFIC or name == "wait_tensor":
            return
        c = Cost(ops=1)
        link = ""
        if ns in _COLLECTIVE_NAMESPACES:
            link = self._collective(name, args, out, c)
        else:
            if _is_view(func):
                return
            if ns == "aten" and name in _DOTS:
                c.flops = _dot_flops(name, args, out)
            elif ns == "aten" and name == "convolution":
                c.flops = 2.0 * _numel(out)
            elif ns == "repro_torch" and name == "flash_attention":
                from repro_torch.kernels.flash_attention.kernel import \
                    flash_flops
                c.flops = float(flash_flops(*args[0].shape))
            if ns == "repro_torch":
                c.kernel_calls[name] = 1
            if ns == "aten" and name in _TRANSCENDENTAL:
                c.transcendentals = float(_numel(out))
            elif ns == "aten" and name in _TRANSCENDENTAL_BY_INPUT:
                c.transcendentals = float(_numel(args[0]))
            c.bytes = float(self._traffic(name, args, kwargs, out))
        scope = self.scope()
        self.cost.add(c)
        self.by_scope.setdefault(scope, Cost()).add(c)
        if self.rows is not None:
            self.rows.append({"scope": scope, "op": str(func),
                              "flops": c.flops, "bytes": c.bytes,
                              "wire": c.nvlink_bytes + c.network_bytes,
                              "link": link})

    @staticmethod
    def _traffic(name: str, args: tuple, kwargs: dict, out: Any) -> int:
        if name in _GATHERS:
            # the data operand is the first; the indices are read whole
            return 2 * _nbytes(out) + _nbytes(list(args[1:]))
        if name in _SCATTERS:
            # indices and values read, the values' region written
            rest = list(args[1:]) + list(kwargs.values())
            values = _tensors(rest)
            return _nbytes(rest) + (_nbytes(values[-1]) if values else 0)
        return _nbytes(list(args) + list(kwargs.values())) + _nbytes(out)

    def _collective(self, name: str, args: tuple, out: Any, c: Cost) -> str:
        import torch.distributed as dist
        kind, which = _COLLECTIVES.get(name, (None, None))
        if kind is None:
            return ""                   # barriers and the like move nothing
        pg = _group(args)
        ranks = dist.get_process_group_ranks(pg) if pg is not None else []
        n = len(ranks)
        if name in ("allgather_", "allgather_into_tensor_coalesced_"):
            b_in, b_out = _nbytes(args[1]), _nbytes(args[0])
        elif name in ("_allgather_base_", "_reduce_scatter_base_",
                      "alltoall_base_", "reduce_scatter_",
                      "reduce_scatter_tensor_coalesced_", "alltoall_"):
            b_in, b_out = _nbytes(args[1]), _nbytes(args[0])
        else:
            b_in = _nbytes(args[0])
            b_out = b_in if name in _IN_PLACE_OUTPUT else _nbytes(out)
        b = b_in if which == "in" else b_out
        me = dist.get_rank()
        if kind in ("send", "recv"):
            peer = ranks[args[2]] if ranks else me
            wire = float(b)
            crosses = peer // self.node_size != me // self.node_size
        else:
            frac = (n - 1) / n if n > 1 else 0.0
            wire = (2.0 * b * frac if kind == "all_reduce"
                    else float(b) if kind == "broadcast" and n > 1
                    else b * frac)
            crosses = len({r // self.node_size for r in ranks}) > 1
        if crosses:
            c.network_bytes = wire
        else:
            c.nvlink_bytes = wire
        c.collectives[kind] = wire
        c.bytes = float(b_out if kind != "send" else 0)
        return "network" if crosses else "nvlink"

    # -- results ----------------------------------------------------------------
    def result(self) -> dict:
        """The reference's per-card cost dict (see :class:`Cost`)."""
        return self.cost.as_dict()

    def breakdown(self) -> list[dict]:
        """One row a scope, in the order the scopes first ran: its path
        and its counts."""
        return [{"scope": s, **c.as_dict()} for s, c in self.by_scope.items()]
