"""Explicit-collective data-parallel training over a process group: the
counterpart of ``repro/parallel/dp.py``.

The reference writes its distributed optimizer the way the paper writes
MPI programs, as a rank-parallel ``shard_map`` with hand-placed
collectives; here each rank is a process of a ``torch.distributed``
group (NCCL on the card, gloo on the CPU), and the step, on the rank's
own rows of the batch, is:

    grads  --reduce-scatter-->  1/W flat shard        (÷ W)
    AdamW on the shard          (ZeRO: m/v/master live sharded, flat)
    params <--all-gather--      updated flat shards   (in bf16)

with the gradient norm for the clip all-reduced from the shards' squared
sums and the metrics averaged over the ranks. ``compression="int8"`` is
the paper's "future upgrade": one scale from the largest magnitude of
every rank (an all-reduce with MAX), the codes sent as int8 by an
all-to-all and summed in int32 on the receiving rank, so the wire
carries one byte a gradient (the reference notes that its first attempt
moved int32 words and saved nothing).

As in the reference, weight decay applies to every element of the flat
vector (its DP path has no per-leaf rank rule, unlike ``optim/adamw.py``),
and the new master is all-gathered in bf16 and cast to each parameter's
dtype, fp32 parameters included. ``zero1`` and ``compression`` of the
``OptimizerConfig`` are not read: the state is always sharded, and the
compression is an argument.

On a gloo group every collective is staged through host memory, and the
reduce-scatter is an all-reduce of which each rank keeps its own chunk
(gloo does not reduce-scatter in every PyTorch build; the sum is the
same, in its own order). The plain step's reduce-scatter and all-gather
are the device spans ``dp_reduce_scatter`` and ``dp_all_gather``
(``data/metrics.py``), recorded inside a micro-batch: their event pairs
hold the collective and its wait for the slowest rank. Without a group
the step is refused; at world 1
it runs its collectives on the group of one. ``lower_dp_cell`` is the
reference's dry-run entry for this trainer: a ``training.Cell`` of one
rank's step over the default group, which the dry-run runs on fake
tensors.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import DTYPES, ModelConfig, OptimizerConfig
from repro_torch.data.metrics import span
from repro_torch.optim.adamw import lr_schedule
from repro_torch.training import loss_and_grads, train_config
from repro_torch.utils import cost_scope, tree_leaves, tree_map

NO_GROUP = ("the data-parallel step runs over a torch.distributed process "
            "group; pass one (a group of one process is world 1)")


def _world(group: Any) -> int:
    if group is None:
        raise ValueError(NO_GROUP)
    return dist.get_world_size(group)


# -- the flat vector ---------------------------------------------------------------
def flatten_params(params: Any, world: int) -> tuple[torch.Tensor, tuple]:
    """Every leaf, in the tree's order, as one fp32 vector zero-padded to a
    multiple of ``world``; and the meta that ``unflatten_params`` needs:
    (the tree with ``None`` leaves, each leaf's shape and dtype, the
    padding)."""
    leaves = tree_leaves(params)
    n = sum(leaf.numel() for leaf in leaves)
    pad = (-n) % world
    flat = torch.empty(n + pad, dtype=torch.float32, device=leaves[0].device)
    off = 0
    for leaf in leaves:
        flat[off:off + leaf.numel()].copy_(leaf.detach().reshape(-1))
        off += leaf.numel()
    flat[n:].zero_()
    meta = (tree_map(lambda _: None, params),
            [(tuple(leaf.shape), leaf.dtype) for leaf in leaves], pad)
    return flat, meta


def unflatten_params(flat: torch.Tensor, meta: tuple) -> Any:
    """The tree of ``flatten_params``' meta from a flat vector (padded or
    not), each leaf in its dtype; a leaf of the vector's dtype is a view
    of it."""
    skeleton, shapes, _ = meta
    pieces, off = [], 0
    for shape, dtype in shapes:
        n = 1
        for d in shape:
            n *= d
        pieces.append(flat[off:off + n].reshape(shape).to(dtype))
        off += n
    it = iter(pieces)
    return tree_map(lambda _: next(it), skeleton)


def shard_batch(batch: dict, group: Any) -> dict:
    """This rank's rows of a global batch: the leading axis split into
    equal parts in rank order, as the reference's ``P(axes)`` splits it."""
    world, rank = _world(group), dist.get_rank(group)

    def rows(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % world:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"over {world} ranks")
        n = x.shape[0] // world
        return x[rank * n:(rank + 1) * n]
    return tree_map(rows, batch)


def init_dp_opt_state(params: Any, group: Any, opt: OptimizerConfig) -> dict:
    """This rank's flat ZeRO shards: 'master' (fp32) its 1/W chunk of the
    flattened parameters, 'm' and 'v' zeros of that size in
    ``opt.state_dtype``, 'step' an int32 zero."""
    world, rank = _world(group), dist.get_rank(group)
    flat, _ = flatten_params(params, world)
    chunk = flat.numel() // world
    master = flat if world == 1 else flat[rank * chunk:
                                          (rank + 1) * chunk].clone()
    sdtype = DTYPES[opt.state_dtype]
    return {"m": torch.zeros(chunk, dtype=sdtype, device=flat.device),
            "v": torch.zeros(chunk, dtype=sdtype, device=flat.device),
            "master": master,
            "step": torch.zeros((), dtype=torch.int32, device=flat.device)}


# -- the collectives ---------------------------------------------------------------
class _Wire:
    """The step's collectives on ``group``; on gloo through host memory."""

    def __init__(self, group: Any) -> None:
        self.group = group
        self.world = _world(group)
        self.rank = dist.get_rank(group)
        self.host = dist.get_backend(group) == "gloo"

    def all_reduce(self, x: torch.Tensor, op: Any) -> torch.Tensor:
        t = x.cpu() if self.host else x
        dist.all_reduce(t, op=op, group=self.group)
        return t.to(x.device)

    def reduce_scatter(self, x2d: torch.Tensor) -> torch.Tensor:
        """(W, chunk) -> this rank's chunk summed over the ranks."""
        if self.host:
            t = x2d.cpu()
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
            return t[self.rank].to(x2d.device)
        out = x2d.new_empty(x2d.shape[1:])
        dist.reduce_scatter_tensor(out, x2d, group=self.group)
        return out

    def all_to_all(self, x2d: torch.Tensor) -> torch.Tensor:
        """(W, chunk): row j to rank j; returns rank j's row for this rank
        at row j."""
        src = x2d.cpu() if self.host else x2d
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return out.to(x2d.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(chunk,) -> (W · chunk,), the ranks' chunks in rank order."""
        if self.host:
            src = x.cpu()
            parts = [torch.empty_like(src) for _ in range(self.world)]
            dist.all_gather(parts, src, group=self.group)
            return torch.cat(parts).to(x.device)
        out = x.new_empty(self.world * x.numel())
        dist.all_gather_into_tensor(out, x, group=self.group)
        return out


# -- the step ----------------------------------------------------------------------
def build_dp_train_step(config: ModelConfig, opt: OptimizerConfig,
                        group: Any, compression: str | None = None
                        ) -> Callable[[dict, dict], tuple[dict, dict]]:
    """``step(state, batch) -> (state, metrics)`` for this rank of
    ``group``: ``state`` is {'params': the whole tree, 'opt':
    ``init_dp_opt_state``}, ``batch`` the rank's rows (``shard_batch``).
    The state is updated in place (the reference donates it). Metrics:
    the model's, 'lr', 'grad_norm' and 'total_loss', each averaged over
    the ranks. The model runs ``train_config``'s schedule, as the
    one-process ``build_train_step`` does."""
    if compression not in (None, "int8"):
        raise ValueError(f"unknown compression {compression!r}")
    wire = _Wire(group)
    world = wire.world
    config = train_config(config)

    def step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        loss, metrics, grads = loss_and_grads(params, batch, config)
        with torch.no_grad(), cost_scope("optimizer"):
            gflat, meta = flatten_params(grads, world)
            del grads
            g2d = gflat.view(world, -1)
            if compression == "int8":
                amax = wire.all_reduce(g2d.abs().max(), dist.ReduceOp.MAX)
                scale = torch.clamp(amax / 127.0, min=1e-12)
                codes = g2d / scale
                del gflat, g2d
                codes = codes.round_().clamp_(-127, 127).to(torch.int8)
                got = wire.all_to_all(codes)
                del codes
                total = got[0].to(torch.int32)
                for row in got[1:]:
                    total += row
                del got
                g_shard = total.to(torch.float32) * scale / world
                del total
            else:
                with span("dp_reduce_scatter", device=True):
                    g_shard = wire.reduce_scatter(g2d) / world
                del gflat, g2d

            o = state["opt"]
            step_no = o["step"] + 1
            gnorm = torch.sqrt(wire.all_reduce(
                torch.sum(torch.square(g_shard)), dist.ReduceOp.SUM))
            if opt.grad_clip > 0:
                # a true division, as jnp's
                limit = torch.full_like(gnorm, opt.grad_clip)
                g_shard = g_shard * torch.clamp(
                    limit / torch.clamp(gnorm, min=1e-9), max=1.0)

            lr = lr_schedule(step_no, opt)
            b1, b2 = opt.b1, opt.b2
            c1 = 1.0 - b1 ** step_no.to(torch.float32)
            c2 = 1.0 - b2 ** step_no.to(torch.float32)
            # fp32 moments: the state itself (updated in place); bf16: a copy
            m = o["m"].float()
            m.mul_(b1).add_(g_shard * (1 - b1))
            v = o["v"].float()
            v.mul_(b2).add_(torch.square(g_shard) * (1 - b2))
            del g_shard
            delta = m / c1
            denom = v / c2
            delta.div_(denom.sqrt_().add_(opt.eps))
            del denom
            master = o["master"]
            delta += master * opt.weight_decay
            master -= delta.mul_(lr)
            del delta
            for ref, new in ((o["m"], m), (o["v"], v)):
                if ref is not new:
                    ref.copy_(new)
            # gather the update in bf16, as the reference does: its params
            # are bf16, so gathering the fp32 master doubles the wire
            with span("dp_all_gather", device=True):
                new_flat = wire.all_gather(master.to(torch.bfloat16))
            off = 0
            for p, (shape, _) in zip(tree_leaves(params), meta[1]):
                p.copy_(new_flat[off:off + p.numel()].view(shape))
                off += p.numel()
            del new_flat
            o["step"] = step_no

            metrics = {**metrics, "lr": lr, "grad_norm": gnorm,
                       "total_loss": loss}
            names = list(metrics)
            mean = wire.all_reduce(torch.stack(
                [metrics[k].to(torch.float32).reshape(()) for k in names]),
                dist.ReduceOp.SUM) / world
        return state, dict(zip(names, mean.unbind()))

    return step


def lower_dp_cell(config: ModelConfig, shape: Any, mesh: Any,
                  opt: OptimizerConfig | None = None,
                  compression: str | None = None) -> Any:
    """The explicit-collective DP train step as a dry-run cell
    (``repro/parallel/dp.py:168``): every device of ``mesh`` a rank of the
    default group, as the reference's step runs data-parallel over all of
    its mesh's axes. ``cell.inputs()`` draws {'params': the whole tree,
    'opt': this rank's ``init_dp_opt_state``} and this rank's rows of the
    global batch (``global_batch`` / world)."""
    from repro_torch.configs import input_specs
    from repro_torch.models.registry import get_model
    from repro_torch.training import Cell, _cell_device, _draw_batch

    opt = opt or OptimizerConfig()
    group = dist.group.WORLD
    world = _world(group)
    n = 1
    for d in getattr(mesh, "shape", (world,)):
        n *= d
    if n != world:
        raise ValueError(f"the DP cell runs over the default group of "
                         f"{world}; the mesh has {n} devices")
    if shape.global_batch % world:
        raise ValueError(f"batch of {shape.global_batch} rows does not "
                         f"split over {world} ranks")
    step = build_dp_train_step(config, opt, group, compression)
    dev = _cell_device(mesh, None)
    specs = input_specs(config, shape)["batch"]
    rows = {k: torch.empty((shape.global_batch // world,) + tuple(v.shape[1:]),
                           dtype=v.dtype, device="meta")
            for k, v in specs.items()}

    def draw() -> tuple:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = get_model(config).init(gen, config)
        state = {"params": params,
                 "opt": init_dp_opt_state(params, group, opt)}
        return state, _draw_batch(gen, config, rows, dev)

    return Cell("train", step, draw)
