"""AdamW with fp32 master weights: the counterpart of
``repro/optim/adamw.py``.

The schedule, the bias corrections, the clipping scale and the update are
fp32 tensor math, as the reference's jnp math is, so that a step of the
port agrees with the reference's to fp32 round-off (Python floats are
float64, and would not).

Weight decay follows the reference's rule, a leaf decays iff its rank is
2 or more, counted on the reference's tree. The reference stacks the
layers of ``transformer``, ``rwkv6`` and ``whisper`` on a leading (L, ...)
axis, so every per-layer norm scale and bias and rwkv6's per-layer
vectors are (L, D) there and decay; ``rglru`` keeps per-layer dicts, so
its 1-D leaves do not. The port keeps every stacked family's layers as a
list of per-layer dicts and rglru's as dicts, so a leaf inside a list
counts one more dimension (``reference_ndim``): the same leaves decay.

The update writes the parameters, the master copy and the moments in
place and returns them: the reference's train step donates its state
(``donate_argnums``), and at full width a second copy of the state would
not fit beside the first.

ZeRO-1 under a mesh (parameters that are DTensors, placed by
``training.shardings_for``): ``init_opt_state`` places 'm', 'v' and
'master' by ``zero1_state_specs``, each parameter's spec with the 'data'
(and 'pod') axis added, so each rank holds 1/data of every leaf that an
axis divides. The update then runs on the state's shards: each gradient
is redistributed to its state's placements (from the pending sum of a
data-sharded batch, a reduce-scatter), clipped, updated in the
reference's fp32 order, and the new parameter, cast to its dtype, is
redistributed back to the parameter's placements (an all-gather).
Without a mesh ``zero1`` and ``compression`` are read as the reference's
``init_opt_state`` and ``adamw_update`` read them, which is not at all:
a ``zero1=True`` step is the ``zero1=False`` step, and int8 compression
belongs to the data-parallel trainer (``parallel/dp.py``), which shards
its own flat state.
"""
from __future__ import annotations

import math
from typing import Any, Sequence

import torch

from repro_torch.configs.base import DTYPES, OptimizerConfig
from repro_torch.parallel.sharding import (P, PartitionSpec, is_dtensor,
                                           map_specs, mesh_axes,
                                           placements, redistribute,
                                           shape_of, spec_of)
from repro_torch.utils import tree_leaves, tree_map


# -- schedule ----------------------------------------------------------------------
def lr_schedule(step: torch.Tensor, config: OptimizerConfig) -> torch.Tensor:
    """Linear warmup, then cosine decay to 10 %, in fp32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(config.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - config.warmup_steps)
                    / max(config.total_steps - config.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * t))
    return config.lr * warm * cos


# -- grad clipping -------------------------------------------------------------------
def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    """The gradients scaled by min(1, max_norm / their global L2 norm),
    each in its dtype, and that norm (fp32)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in tree_leaves(grads)))
    # a true division, as jnp's (a Python scalar over a tensor divides by
    # a reciprocal)
    limit = torch.full_like(gnorm, max_norm)
    scale = torch.clamp(limit / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


# -- ZeRO-1 sharding --------------------------------------------------------------
def add_zero_axis(spec: Sequence[Any], shape: tuple[int, ...], mesh: Any,
                  axis: str = "data") -> PartitionSpec:
    """``axis`` added to the first unsharded dimension it divides
    (``repro/optim/adamw.py:110``); the spec as it was when the mesh lacks
    the axis, already uses it (FSDP weights), or no dimension fits."""
    sizes = mesh_axes(mesh)
    if axis not in sizes:
        return P(*spec)
    used = {a for part in spec if part is not None
            for a in (part if isinstance(part, tuple) else (part,))}
    if axis in used:
        return P(*spec)
    n = sizes[axis]
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, cur) in enumerate(zip(shape, parts)):
        if cur is None and dim % n == 0 and dim >= n:
            parts[i] = axis
            return P(*parts)
    return P(*spec)


def zero1_state_specs(param_specs: Any, param_shapes: Any, mesh: Any,
                      config: OptimizerConfig) -> dict:
    """The optimizer state's spec tree (``repro/optim/adamw.py:129``):
    with ``zero1`` each leaf's parameter spec plus 'data', then 'pod'
    (``add_zero_axis``); 'step' replicated. The port's layers are per-layer
    leaves, so where the reference's stacked (L, ...) leaf takes the axis
    on L, the port's takes it on the leaf's first divisible dimension, or
    stays replicated when none divides (ROADMAP Queue 3)."""
    def zspec(spec: Any, leaf: Any) -> PartitionSpec:
        if not config.zero1:
            return P(*spec)
        spec = add_zero_axis(spec, shape_of(leaf), mesh, axis="data")
        return add_zero_axis(spec, shape_of(leaf), mesh, axis="pod")

    mz = map_specs(zspec, param_specs, param_shapes)
    state = {"m": mz, "v": mz, "step": P()}
    if config.master_fp32:
        state["master"] = mz
    return state


# -- state ---------------------------------------------------------------------------
def _zero_placed(p: torch.Tensor, t: torch.Tensor,
                 config: OptimizerConfig) -> torch.Tensor:
    """``t``, a state leaf made like the DTensor parameter ``p``, placed
    by ``p``'s spec with the ZeRO axes (``zero1_state_specs``' rule); a
    copy of this rank's block only, so the full leaf is freed."""
    from torch.distributed.tensor import DTensor

    mesh = p.device_mesh
    spec = spec_of(p.placements, mesh)
    zspec = zero1_state_specs(spec, p, mesh, config)["m"]
    t = redistribute(t, mesh, placements(zspec, mesh))
    return DTensor.from_local(t.to_local().clone(), mesh, t.placements,
                              run_check=False)


def init_opt_state(params: Any, config: OptimizerConfig) -> dict:
    """'m', 'v': zeros in ``state_dtype``; 'step': an int32 zero; with
    ``master_fp32`` 'master', an fp32 copy of the parameters. A DTensor
    parameter's leaves are placed by ``zero1_state_specs``."""
    sdtype = DTYPES[config.state_dtype]
    first = tree_leaves(params)[0]
    device = (first.to_local() if is_dtensor(first) else first).device

    def leaf(p: torch.Tensor, make) -> torch.Tensor:
        t = make(p)
        return _zero_placed(p, t, config) if is_dtensor(p) else t

    state = {"m": tree_map(lambda p: leaf(
                 p, lambda q: torch.zeros_like(q, dtype=sdtype)), params),
             "v": tree_map(lambda p: leaf(
                 p, lambda q: torch.zeros_like(q, dtype=sdtype)), params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if config.master_fp32:
        state["master"] = tree_map(lambda p: leaf(
            p, lambda q: q.detach().to(torch.float32, copy=True)), params)
    return state


def _to_state(g: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """A gradient on its state leaf's placements (a DTensor state's)."""
    if is_dtensor(m):
        return redistribute(g, m.device_mesh, m.placements)
    return g


def reference_ndim(params: Any) -> Any:
    """Each leaf's rank in the reference's tree: one more than its own
    inside a list (the layers the reference stacks on L)."""
    def walk(node: Any, stacked: bool) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, stacked) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, True) for v in node)
        return node.dim() + int(stacked)
    return walk(params, False)


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: dict,
                 config: OptimizerConfig) -> tuple[Any, dict, dict]:
    """One AdamW step, written into ``params`` and ``state`` in place.
    Returns (params, state, {'lr', 'grad_norm'}). Under a mesh each
    gradient is first redistributed to its state's placements, and the
    new parameter back to the parameter's (the module's docstring)."""
    grads = tree_map(_to_state, grads, state["m"])
    step = state["step"] + 1
    lr = lr_schedule(step, config)
    if config.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, config.grad_clip)
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=step.device)
    b1, b2 = config.b1, config.b2
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)
    sdtype = DTYPES[config.state_dtype]
    ref = state.get("master", params)

    def upd(p_ref: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
            v: torch.Tensor, p: torch.Tensor, ndim: int) -> None:
        g32 = g.float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
        mh, vh = m32 / c1, v32 / c2
        delta = mh / (torch.sqrt(vh) + config.eps)
        p32 = p_ref.float()
        if config.weight_decay > 0 and ndim >= 2:
            delta = delta + config.weight_decay * p32
        new = p32 - lr * delta
        m.copy_(m32.to(sdtype))
        v.copy_(v32.to(sdtype))
        if p_ref is not p:
            p_ref.copy_(new)
        new = new.to(p.dtype)
        if is_dtensor(p):
            new = redistribute(new, p.device_mesh, p.placements)
        p.copy_(new)

    tree_map(upd, ref, grads, state["m"], state["v"], params,
             reference_ndim(params))
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
