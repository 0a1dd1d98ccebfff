"""GPipe pipeline parallelism over the 'pod' axis: the counterpart of
``repro/parallel/pp.py``.

Cross-pod links are the slow ones, so the multi-pod mesh wants the
parallelism with the least traffic between pods: a pipeline moves only
microbatch activations (mb·S·D a boundary a tick), where data parallelism
moves the gradients.

The reference runs ``gpipe_apply`` under a ``shard_map`` manual over 'pod'
only, GSPMD handling 'data' and 'model' inside each stage; the port runs
it on every rank as an SPMD program over ``torch.distributed``:

* stage r is this rank's coordinate on the axis; it runs its own
  ``num_layers/n`` entries of the layer list (the port keeps the layers
  as a list, where the reference shards a stacked (L, ...) tree on L),
  under the stage's sub-mesh of the other axes, where ``logical_constraint``
  places the activations as it does for the rest of the port;
* the schedule is plain GPipe: M microbatches over M + n - 1 ticks, every
  stage computing every tick (the bubble, (n - 1)/M, is computed, so the
  FLOPs are the reference's); stage 0 feeds microbatch min(t, M - 1),
  stage r > 0 what stage r - 1 produced the tick before, and the first
  tick's carry is zeros;
* the hop between stages is a send to the next stage and a receive from
  the previous one on the axis's process group (``_Hop``), whose backward
  pass sends each gradient the other way: the transpose of the
  reference's ``ppermute``. Each stage receives before it sends, so the
  blocking calls run down the chain without a deadlock;
* the last stage's outputs go to every rank (``_FromLast``), as the
  reference's masked ``psum`` does. The output is then the same on every
  rank, and so is its gradient: the backward pass takes the last stage's
  own and sums none over the stages, which would make the gradient n
  times too large.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.parallel.sharding import (current_rules, mesh_axes,
                                           use_mesh, whole)


def _peer(group: Any, stage: int) -> int:
    import torch.distributed as dist
    return dist.get_global_rank(group, stage)


def _hop(x: torch.Tensor, group: Any, r: int, n: int, up: bool
         ) -> torch.Tensor:
    """Stage r sends ``x`` one stage on (``up``: to r + 1, else to r - 1)
    and returns what the stage behind it sent, zeros at the chain's
    start; receive first, then send."""
    import torch.distributed as dist

    src, dst = (r - 1, r + 1) if up else (r + 1, r - 1)
    out = torch.zeros_like(x)
    if 0 <= src < n:
        dist.recv(out, src=_peer(group, src), group=group)
    if 0 <= dst < n:
        dist.send(x.contiguous(), dst=_peer(group, dst), group=group)
    return out


class _Hop(torch.autograd.Function):
    """The activations one stage on; the gradients one stage back."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any, r: int, n: int
                ) -> torch.Tensor:
        ctx.args = group, r, n
        return _hop(x, group, r, n, up=True)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        # a stage's DTensor ops hand back the gradient of its plain input
        # as a DTensor of the sub-mesh: the whole tensor crosses
        return (_hop(whole(g), *ctx.args, up=False),) + (None,) * 3


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every stage (a broadcast); the gradient
    of the last stage's own, zeros on the others."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any, r: int, n: int
                ) -> torch.Tensor:
        import torch.distributed as dist

        ctx.last = r == n - 1
        out = x.clone()
        dist.broadcast(out, src=_peer(group, n - 1), group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = whole(g)
        return (g if ctx.last else torch.zeros_like(g)), None, None, None


def gpipe_apply(stage_fn: Callable[[torch.Tensor, Any], torch.Tensor],
                stage_params: Any, mbs: torch.Tensor, n_stages: int,
                axis: str = "pod", mesh: Any = None) -> torch.Tensor:
    """Run ``stage_fn`` as a GPipe pipeline of ``n_stages`` stages over
    the ``axis`` of ``mesh`` (the active mesh by default), this rank being
    the stage of its coordinate there.

    mbs: (M, mb, S, D) microbatch activations, the same on every rank
    (consumed by stage 0). Returns (M, mb, S, D) outputs, the same on every
    rank (broadcast from the last stage)."""
    from repro_torch.parallel.sharding import current_mesh

    mesh = current_mesh() if mesh is None else mesh
    group = mesh.get_group(axis)
    r = mesh.get_local_rank(axis)
    M = mbs.shape[0]
    first = torch.tensor(r == 0, device=mbs.device)
    carry = torch.zeros_like(mbs[0])
    ys = []
    for t in range(M + n_stages - 1):
        recv = _Hop.apply(carry, group, r, n_stages)   # from stage r - 1
        # a select, as the reference's: every stage's hop stays in the
        # graph, so every stage takes part in each backward hop
        x_in = torch.where(first, mbs[min(t, M - 1)], recv)
        carry = whole(stage_fn(x_in, stage_params))
        ys.append(carry)
    outs = torch.stack(ys[n_stages - 1:])               # (M, mb, S, D)
    return _FromLast.apply(outs, group, r, n_stages)


def pipeline_layers(run_block: Callable[[torch.Tensor, Any], torch.Tensor],
                    layer_params: list, x: torch.Tensor, mesh: Any,
                    num_layers: int, microbatches: int,
                    axis: str = "pod") -> torch.Tensor:
    """Pipeline a transformer body over the ``axis`` of ``mesh``.

    x: (B, S, D) activations, the same on every rank (a DTensor is taken
    whole); ``layer_params``: the list of per-layer parameters, every
    rank's, of which stage r runs entries [r·L/n, (r + 1)·L/n);
    run_block(x, one_layer_params) -> x. Without a second stage, the layers
    in turn. Where the blocks place their activations on the stage's
    sub-mesh, their parameters are DTensors of it (``place_tree`` on
    ``mesh[other axes]``), and the forward and backward passes run under
    ``use_mesh(mesh, ...)``, as a sharded step's do."""
    n_stages = mesh_axes(mesh).get(axis, 1)
    x = whole(x)
    if n_stages <= 1:
        for p in layer_params:
            x = run_block(x, p)
        return x
    assert num_layers % n_stages == 0, "layers must split evenly into stages"
    B = x.shape[0]
    assert B % microbatches == 0, "batch must split into microbatches"
    mb = B // microbatches
    mbs = x.reshape(microbatches, mb, *x.shape[1:])
    per = num_layers // n_stages
    r = mesh.get_local_rank(axis)
    others = tuple(a for a in mesh.mesh_dim_names if a != axis)
    sub = mesh[others] if others else None
    rules = current_rules()

    def stage_fn(x_in: torch.Tensor, params_stage: list) -> torch.Tensor:
        with use_mesh(sub, rules):
            for p in params_stage:
                x_in = run_block(x_in, p)
        return x_in

    out = gpipe_apply(stage_fn, layer_params[r * per:(r + 1) * per], mbs,
                      n_stages, axis=axis, mesh=mesh)
    return out.reshape(B, *x.shape[1:])
