"""Logical-axis sharding over a ``DeviceMesh``: the counterpart of
``repro/parallel/sharding.py``.

Models annotate tensors with *logical* axis names ('batch', 'heads', 'ff',
'experts', ...); a rule table maps them to the axes of a mesh, ('data',
'model') on one pod and ('pod', 'data', 'model') across pods. The
reference hands the resulting ``PartitionSpec``s to GSPMD, which
propagates shardings in the compiler; the port hands them to DTensor,
which propagates them at run time:

* a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
  ``mesh_dim_names`` are the reference's axis names. Where only the specs
  are wanted (the tests against the reference, a dry-run), a mapping of
  axis name to size stands in for it (an *abstract* mesh);
* a spec is a ``PartitionSpec``, a tuple of one entry a tensor dimension
  (a mesh axis, a tuple of them, or None), compared element by element
  with the reference's;
* a sharding is one DTensor placement a mesh dimension (``placements``):
  ``Shard(d)`` where the spec puts that mesh axis on dimension d, else
  ``Replicate()``. A dimension over ('pod', 'data') is ``Shard(d)`` on
  both, which DTensor splits in mesh-dimension order, pod-major as the
  reference's tuple is. The one tuple against the mesh's order is the
  'experts_a2a' rule's ('model', 'data'): whole experts model-major, rank
  (m, d) holding block m·|data| + d, as the reference's all-to-all MoE
  asks (``models/moe.py``); 'model' is ``Shard(d)`` and 'data'
  DTensor's ``_StridedShard(d, split_factor=|model|)``, which splits
  'model' first;
* ``logical_constraint`` is a ``redistribute`` to the spec's placements,
  a no-op without a mesh or on a mesh of one device, as the reference's
  ``with_sharding_constraint`` is.

Under ``use_mesh`` with a ``DeviceMesh`` plain tensors meet DTensors under
DTensor's implicit replication: a tensor made at its global shape on
every rank (a position table, a mask, a zero carry) is the same on every
rank, which is what ``Replicate()`` says.

The port keeps a stacked family's layers as a list of per-layer dicts,
not stacked on L, so a "layers" rule that names a mesh axis has nothing
to shard and is refused; no config sets one.

Gloo with CUDA tensors: DTensor's collectives on a gloo group crash the
process on the card (torch 2.11, a segmentation fault at the first
all-gather), so a mesh of gloo processes on a GPU runs on the
``HOST_STAGED`` backend (``register_host_staged``): a process group
that copies each collective's tensors to host memory, runs it there on
gloo, and copies the result back. It serves gloo groups only, is chosen
by name when the group is made, and never stands in for NCCL.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
import time
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import torch

# Logical axis -> preferred mesh axes (those that exist on the mesh are
# used; a tuple shards over the product of its axes): the reference's
# table (``repro/parallel/sharding.py:38``).
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,            # attention-internal sequence axis (kept whole)
    "act_seq": "model",     # residual-stream sequence axis: Megatron-style
                            # sequence parallelism, dropped where S % model
                            # != 0 (a decode's S = 1)
    "seq_shard": None,      # opt-in context parallelism
    "embed": None,          # d_model is kept replicated by default
    "embed_fsdp": None,     # opt-in: shard d_model dim of weights over 'data'
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "experts_a2a": ("model", "data"),  # a2a EP: whole experts per device
    "expert_in": None,      # opt-in FSDP for expert weights: 'data'
    "expert_cap": "data",   # expert capacity dim follows the data shards
    "layers": None,         # the reference's scan-stacked layer dim
    "conv": None,
    "lru": "model",
    "frames": None,
    "null": None,
}

LAYERS_REFUSED = (
    "a 'layers' rule that names a mesh axis is refused: the port keeps a "
    "stacked family's layers as a list of per-layer tensors, so there is "
    "no layer dimension to shard (no config sets such a rule)")


class PartitionSpec(tuple):
    """One entry a tensor dimension: a mesh axis name, a tuple of them, or
    None; trailing Nones trimmed. A tuple, so that it compares element by
    element with the reference's ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts: Any) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh: Any) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh``, or of an abstract mesh (a
    mapping of the two); {} for None."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def mesh_size(mesh: Any) -> int:
    return math.prod(mesh_axes(mesh).values())


def _axes_of(part: Any) -> tuple[str, ...]:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


@dataclass
class ShardingRules:
    """The rule table: ``DEFAULT_RULES`` with a config's overrides. Keys
    that start with '_' are options of the model (``_skip_blocks``,
    ``_moe_impl``), not logical axes, and are never looked up."""
    overrides: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.overrides.get("layers") is not None:
            raise ValueError(LAYERS_REFUSED)

    def physical(self, logical: str) -> Any:
        table = {**DEFAULT_RULES, **self.overrides}
        if logical not in table:
            raise KeyError(f"unknown logical axis {logical!r}")
        return table[logical]

    def spec(self, logical_axes: Sequence[str | None],
             mesh: Any) -> PartitionSpec:
        """The spec of a tensor annotated with logical axis names. Mesh
        axes the mesh lacks ('pod' on one pod) are dropped, so one
        annotation serves every mesh; no mesh axis is used twice."""
        used: set[str] = set()
        parts: list[Any] = []
        names = set(mesh_axes(mesh))
        for name in logical_axes:
            phys = None if name is None else self.physical(name)
            cand = tuple(a for a in _axes_of(phys)
                         if a in names and a not in used)
            if not cand:
                parts.append(None)
            elif len(cand) == 1:
                parts.append(cand[0])
            else:
                parts.append(cand)
            used.update(cand)
        while parts and parts[-1] is None:
            parts.pop()
        return P(*parts)


# -- the active mesh and rules ------------------------------------------------------
class _ShardingContext(threading.local):
    def __init__(self) -> None:
        self.mesh: Any = None
        self.rules: ShardingRules = ShardingRules()


_ctx = _ShardingContext()


@contextlib.contextmanager
def use_mesh(mesh: Any, rules: ShardingRules | None = None):
    """Activate a mesh and a rule table for ``logical_constraint`` and
    ``named_sharding``; with a ``DeviceMesh``, under DTensor's implicit
    replication of plain tensors (the module's docstring)."""
    prev = (_ctx.mesh, _ctx.rules)
    _ctx.mesh = mesh
    if rules is not None:
        _ctx.rules = rules
    try:
        if mesh is not None and not isinstance(mesh, Mapping):
            with _implicit_replication():
                yield
        else:
            yield
    finally:
        _ctx.mesh, _ctx.rules = prev


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's ``implicit_replication`` that restores the flag it found
    on exit: the flag is one for the process, and ``use_mesh`` nests (a
    recompute in the backward pass re-enters it), where DTensor's own
    context manager would clear it for the outer one."""
    from torch.distributed.tensor import DTensor
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def current_mesh() -> Any:
    return _ctx.mesh


def current_rules() -> ShardingRules:
    return _ctx.rules


def model_degree() -> int:
    """The active mesh's 'model' axis size; 1 without a mesh."""
    return mesh_axes(_ctx.mesh).get("model", 1)


def drop_indivisible(spec: Sequence[Any], shape: tuple[int, ...],
                     mesh: Any) -> PartitionSpec:
    """Drop the mesh axes whose size does not divide the tensor's
    dimension, keeping the longest prefix of a tuple that does (e.g. 56
    query heads over a 16-way 'model' axis stay whole): the tensor falls
    back to a coarser sharding instead of uneven shards."""
    sizes = mesh_axes(mesh)
    parts: list[Any] = []
    for i, part in enumerate(spec):
        if part is None or i >= len(shape):
            parts.append(None)
            continue
        axes = _axes_of(part)
        if shape[i] % math.prod(sizes[a] for a in axes) != 0:
            kept, size = [], 1
            for a in axes:
                if shape[i] % (size * sizes[a]) == 0:
                    kept.append(a)
                    size *= sizes[a]
            part = tuple(kept) if len(kept) > 1 else (kept[0] if kept
                                                      else None)
        parts.append(part)
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


# -- placements and DTensors -------------------------------------------------------
# The one tuple of mesh axes that may run against the mesh's order: the
# 'experts_a2a' rule's, whole experts model-major
MODEL_MAJOR = ("model", "data")


def _strided_shard():
    from torch.distributed.tensor.placement_types import _StridedShard
    return _StridedShard


def placements(spec: Sequence[Any], mesh: Any) -> tuple:
    """One DTensor placement a mesh dimension: ``Shard(d)`` where ``spec``
    puts that axis on tensor dimension d, else ``Replicate()``, which an
    axis of size 1 also gets (the same layout; torch 2.11's view strategy
    refuses to flatten a dimension sharded over one device). A tuple of
    axes on one dimension must follow the mesh's order (DTensor splits in
    mesh-dimension order), but for ``MODEL_MAJOR`` on a mesh that has
    'data' before 'model': 'data' is then a ``_StridedShard`` that splits
    each 'model' block (the module's docstring)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_axes(mesh)
    names = list(sizes)
    out: list[Any] = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        axes = _axes_of(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) and axes != MODEL_MAJOR:
            raise ValueError(f"spec {tuple(spec)}: the axes {part} of "
                             f"dimension {d} are not in the mesh's order "
                             f"{names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
        if idx != sorted(idx) and all(sizes[a] > 1 for a in axes):
            out[names.index("data")] = _strided_shard()(
                d, split_factor=sizes["model"])
    return tuple(out)


def spec_of(places: Sequence[Any], mesh: Any) -> PartitionSpec:
    """The spec that ``placements`` turns into ``places`` (Shard,
    ``placements``' strided 'data' and Replicate only)."""
    from torch.distributed.tensor import Replicate, Shard

    strided = _strided_shard()
    names = list(mesh_axes(mesh))
    dims: dict[int, list[str]] = {}
    after: dict[int, list[str]] = {}     # split inside the others' blocks
    for name, p in zip(names, places):
        if isinstance(p, strided):
            after.setdefault(p.dim, []).append(name)
        elif isinstance(p, Shard):
            dims.setdefault(p.dim, []).append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"no spec for the placement {p}")
    for d, axes in after.items():
        dims.setdefault(d, []).extend(axes)
    parts = [None] * (max(dims) + 1 if dims else 0)
    for d, axes in dims.items():
        parts[d] = axes[0] if len(axes) == 1 else tuple(axes)
    return P(*parts)


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_shard(x: torch.Tensor, mesh: Any, places: Sequence[Any]
                ) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``places``
    (even shards; ``drop_indivisible`` sees to that), a view of ``x``: on
    each dimension the block whose index is this rank's coordinates on
    the dimension's axes, the first axis of the spec's tuple the most
    significant."""
    sizes = mesh_axes(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    for d, part in enumerate(spec_of(places, mesh)):
        axes = _axes_of(part)
        if not axes:
            continue
        n, block = 1, 0
        for a in axes:
            n, block = n * sizes[a], block * sizes[a] + coord[a]
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(x.shape)} does not "
                             f"divide over {n}")
        x = x.chunk(n, dim=d)[block]
    return x


def distribute(x: torch.Tensor, mesh: Any, places: Sequence[Any]):
    """A DTensor of ``x``, the same global tensor on every rank, placed by
    ``places``: each rank keeps its own block, no collective."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local_shard(x, mesh, places), mesh,
                              tuple(places), run_check=False)


def redistribute(x: torch.Tensor, mesh: Any, places: Sequence[Any]):
    """``x`` as a DTensor placed by ``places``: a DTensor is
    redistributed (collectives where a placement changes), a plain
    tensor, replicated by the module's convention, keeps its own block."""
    if not is_dtensor(x):
        return distribute(x, mesh, places)
    if tuple(x.placements) == tuple(places):
        return x
    return x.redistribute(mesh, tuple(places))


def whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor as the plain full tensor on this rank (an all-gather of
    its shards, differentiable); a plain tensor as it is. For the steps
    DTensor has no sharding strategy for, run on every rank alike."""
    return x.full_tensor() if is_dtensor(x) else x


def summed(places: Sequence[Any]) -> tuple:
    """``places`` with every pending sum (a Partial placement) as
    Replicate: where a pending sum is taken whole (a lookup in a
    'vocab'-sharded table leaves one, on a mesh of one device too)."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if p.is_partial() else p for p in places)


def replicated(x: torch.Tensor, mesh: Any):
    """A plain tensor, the same on every rank, as a replicated DTensor."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def logical_constraint(x: torch.Tensor, *logical_axes: str | None
                       ) -> torch.Tensor:
    """``x`` redistributed to its logical axes' spec on the active mesh,
    after ``drop_indivisible``; unchanged without a mesh or on a mesh of
    one device."""
    mesh = _ctx.mesh
    if mesh is None or mesh_size(mesh) == 1:
        return x
    spec = drop_indivisible(_ctx.rules.spec(logical_axes, mesh),
                            tuple(x.shape), mesh)
    return redistribute(x, mesh, placements(spec, mesh))


# -- spec trees --------------------------------------------------------------------
def map_specs(fn: Callable, spec_tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of a spec tree, nested dicts and lists whose
    leaves are tuples (logical axes or ``PartitionSpec``s), with the
    matching leaves of ``rest``."""
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest))
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [map_specs(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(spec_tree)]
    return fn(spec_tree, *rest)


def shape_of(leaf: Any) -> tuple[int, ...]:
    """The shape of a tensor (a meta one included), of a (shape, dtype)
    record, or () for a Python scalar (a cache's 'pos')."""
    shape = getattr(leaf, "shape", ())
    return tuple(int(s) for s in shape)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def named_sharding(logical_axes: Sequence[str | None], mesh: Any = None,
                   rules: ShardingRules | None = None) -> NamedSharding:
    mesh = mesh if mesh is not None else _ctx.mesh
    rules = rules or _ctx.rules
    if mesh is None:
        raise ValueError("no active mesh")
    return NamedSharding(mesh, rules.spec(logical_axes, mesh))


def tree_shardings(spec_tree: Any, mesh: Any = None,
                   rules: ShardingRules | None = None) -> Any:
    """A tree of logical-axis tuples as ``NamedSharding``s."""
    return map_specs(lambda axes: named_sharding(axes, mesh, rules),
                     spec_tree)


def tree_specs(spec_tree: Any, mesh: Any,
               rules: ShardingRules | None = None) -> Any:
    rules = rules or _ctx.rules
    return map_specs(lambda axes: rules.spec(axes, mesh), spec_tree)


def tree_specs_shaped(spec_tree: Any, shape_tree: Any, mesh: Any,
                      rules: ShardingRules | None = None) -> Any:
    """``tree_specs`` with the axes that do not divide the leaves' shapes
    dropped (``shape_tree``: tensors, meta tensors or (shape, dtype)
    records)."""
    rules = rules or _ctx.rules
    return map_specs(lambda axes, leaf: drop_indivisible(
        rules.spec(axes, mesh), shape_of(leaf), mesh), spec_tree,
        shape_tree)


def place_tree(tree: Any, spec_tree: Any, mesh: Any) -> Any:
    """Each tensor leaf of ``tree`` as a DTensor on ``mesh`` placed by its
    ``PartitionSpec`` in ``spec_tree`` (``distribute``: every rank holds
    the same tree, so no collective); other leaves as they are."""
    def place(spec: Any, leaf: Any) -> Any:
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute(leaf, mesh, placements(spec, mesh))
    return map_specs(place, spec_tree, tree)


def zeros_logical(make: Callable[[Any], Any], logical_tree: Any,
                  device: Any) -> Any:
    """A fresh tree of zeros (a cache; ``make(device)`` builds it at its
    global shapes) placed by its logical axes on the active
    ``DeviceMesh``, each rank allocating only its own block: the tree is
    made on the meta device, and each leaf's local block drawn as zeros on
    ``device`` (the reference's cache, zeros under a sharding constraint
    inside ``jit``, is allocated so by XLA). ``make(device)`` as it is
    without a mesh."""
    from torch.distributed.tensor import DTensor

    mesh = _ctx.mesh
    if mesh is None or isinstance(mesh, Mapping):
        return make(device)
    meta = make(torch.device("meta"))
    specs = tree_specs_shaped(logical_tree, meta, mesh, _ctx.rules)

    def place(spec: Any, leaf: Any) -> Any:
        if not isinstance(leaf, torch.Tensor):
            return leaf
        places = placements(spec, mesh)
        local = local_shard(leaf, mesh, places)
        return DTensor.from_local(
            torch.zeros(local.shape, dtype=leaf.dtype, device=device), mesh,
            places, run_check=False)
    return map_specs(place, specs, meta)


def like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` on ``ref``'s placements when ``ref`` is a DTensor (before an
    in-place copy into ``ref``)."""
    if is_dtensor(ref):
        return redistribute(x, ref.device_mesh, ref.placements)
    return x


# -- gloo through host memory --------------------------------------------------------
HOST_STAGED = "host_gloo"


def _work(result: Any):
    from torch._C._distributed_c10d import _create_work_from_future
    fut = torch.futures.Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


@functools.cache
def host_staged_class():
    """The ``HOST_STAGED`` process group's class (made on first use, so
    that importing this module reads nothing of ``torch.distributed``).
    Its ``seconds`` adds up the wall time of every collective, the host
    copies included."""
    import torch.distributed as dist
    from torch._C._distributed_c10d import (AllgatherOptions,
                                            AllreduceOptions,
                                            AllToAllOptions, BarrierOptions,
                                            BroadcastOptions,
                                            ReduceScatterOptions)

    class HostStagedGloo(dist.ProcessGroup):
        """A process group whose every collective copies its tensors to
        host memory, runs on a gloo group there, and copies the result
        back into the caller's tensors (on any device). The module's
        docstring says why; it is slow by design, a copy each way."""

        seconds = 0.0

        def __init__(self, store: Any, rank: int, size: int,
                     timeout: Any) -> None:
            super().__init__(rank, size)
            self._rank, self._size = rank, size
            self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)

        def getBackendName(self) -> str:
            return HOST_STAGED

        @property
        def group_name(self) -> str:
            # the name c10d registered this group under (a Python group
            # does not carry it itself)
            return dist.distributed_c10d._world.pg_names[self]

        @property
        def pg_name(self) -> str:
            return self.group_name

        def _allreduce_host(self, t: torch.Tensor, op: Any) -> torch.Tensor:
            host = t.detach().to("cpu", copy=True)
            opts = AllreduceOptions()
            opts.reduceOp = op
            self._gloo.allreduce([host], opts).wait()
            return host

        def _gather_host(self, t: torch.Tensor) -> list[torch.Tensor]:
            host = t.detach().to("cpu", copy=True).contiguous()
            parts = [torch.empty_like(host) for _ in range(self._size)]
            self._gloo.allgather([parts], [host]).wait()
            return parts

        def allreduce(self, tensors, opts=AllreduceOptions()):
            for t in tensors:
                t.copy_(self._allreduce_host(t, opts.reduceOp))
            return _work(tensors)

        def allgather(self, outputs, inputs, opts=AllgatherOptions()):
            for outs, t in zip(outputs, inputs):
                for o, part in zip(outs, self._gather_host(t)):
                    o.copy_(part)
            return _work(outputs)

        def all_gather_single(self, output, input, opts=AllgatherOptions()):
            output.copy_(torch.cat(self._gather_host(input)).view_as(output))
            return _work(output)

        def allgather_into_tensor_coalesced(self, outputs, inputs,
                                            opts=AllgatherOptions()):
            for o, t in zip(outputs, inputs):
                self.all_gather_single(o, t, opts)
            return _work(outputs)

        all_gather_single_coalesced = allgather_into_tensor_coalesced

        def reduce_scatter_single(self, output, input,
                                  opts=ReduceScatterOptions()):
            total = self._allreduce_host(input, opts.reduceOp)
            output.copy_(total.chunk(self._size)[self._rank].view_as(output))
            return _work(output)

        def reduce_scatter_tensor_coalesced(self, outputs, inputs,
                                            opts=ReduceScatterOptions()):
            for o, t in zip(outputs, inputs):
                self.reduce_scatter_single(o, t, opts)
            return _work(outputs)

        reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

        def all_to_all_single(self, output, input, output_split_sizes=None,
                              input_split_sizes=None,
                              opts=AllToAllOptions()):
            if output_split_sizes or input_split_sizes:
                if len(set(output_split_sizes or [0])) > 1 or \
                        len(set(input_split_sizes or [0])) > 1:
                    raise NotImplementedError(
                        f"{HOST_STAGED}: all-to-all with unequal splits")
            host = input.detach().to("cpu", copy=True).contiguous()
            out = torch.empty_like(host)
            self._gloo.alltoall_base(out, host, [], [],
                                     AllToAllOptions()).wait()
            output.copy_(out.view_as(output))
            return _work(output)

        def broadcast(self, tensors, opts=BroadcastOptions()):
            host = [t.detach().to("cpu", copy=True) for t in tensors]
            self._gloo.broadcast(host, opts).wait()
            for t, h in zip(tensors, host):
                t.copy_(h)
            return _work(tensors)

        def barrier(self, opts=BarrierOptions()):
            self._gloo.barrier(opts).wait()
            return _work(None)

        # point to point (a pipeline's hops, ``parallel/pp.py``): each
        # returns once its tensors are through, so a caller that sends and
        # receives orders its calls as a blocking MPI program would
        def send(self, tensors, dstRank, tag):
            host = [t.detach().to("cpu", copy=True).contiguous()
                    for t in tensors]
            self._gloo.send(host, dstRank, tag).wait()
            return _work(tensors)

        def recv(self, tensors, srcRank, tag):
            host = [torch.empty(t.shape, dtype=t.dtype) for t in tensors]
            self._gloo.recv(host, srcRank, tag).wait()
            for t, h in zip(tensors, host):
                t.copy_(h)
            return _work(tensors)

    for name in ("allreduce", "allgather", "all_gather_single",
                 "reduce_scatter_single", "all_to_all_single", "broadcast",
                 "barrier", "send", "recv"):
        setattr(HostStagedGloo, name, _timed(getattr(HostStagedGloo, name)))
    for alias, name in (("allreduce_coalesced", "allreduce"),
                        ("_allgather_base", "all_gather_single"),
                        ("_reduce_scatter_base", "reduce_scatter_single"),
                        ("alltoall_base", "all_to_all_single")):
        setattr(HostStagedGloo, alias, getattr(HostStagedGloo, name))
    return HostStagedGloo


def _timed(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def run(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(self, *args, **kw)
        finally:
            type(self).seconds += time.perf_counter() - t0
    return run


def _create_host_staged(store: Any, rank: int, size: int, timeout: Any):
    return host_staged_class()(store, rank, size, timeout)


def register_host_staged() -> str:
    """Register the ``HOST_STAGED`` backend (once) and return its name,
    for ``torch.distributed.init_process_group(backend=...)``."""
    import torch.distributed as dist
    if not hasattr(dist.Backend, HOST_STAGED.upper()):
        dist.Backend.register_backend(HOST_STAGED, _create_host_staged,
                                      devices=["cpu", "cuda"])
    return HOST_STAGED


def gather_tree(tree: Any) -> Any:
    """Each DTensor leaf as the full tensor on every rank; other leaves as
    they are."""
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v) for v in tree)
    return whole(tree)
