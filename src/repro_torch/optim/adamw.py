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
not fit beside the first. ZeRO-1 (``zero1``, with ``zero1_state_specs``)
and int8 gradient compression (``compression``) come with the port's mesh
(ROADMAP Queue 1 item 9); until then ``init_opt_state`` and
``adamw_update`` refuse a config that asks for either, rather than ignore
it. The data-parallel trainer (``parallel/dp.py``) shards its own flat
state and compresses its gradients without this module's update.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import DTYPES, OptimizerConfig
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


# -- state ---------------------------------------------------------------------------
def _refuse_mesh_options(config: OptimizerConfig) -> None:
    if config.zero1 or config.compression is not None:
        raise NotImplementedError(
            f"adamw: zero1={config.zero1}, compression="
            f"{config.compression!r}: ZeRO-1 and gradient compression come "
            f"with the port's mesh (ROADMAP Queue 1 item 9); pass "
            f"zero1=False and compression=None")


def init_opt_state(params: Any, config: OptimizerConfig) -> dict:
    """'m', 'v': zeros in ``state_dtype``; 'step': an int32 zero; with
    ``master_fp32`` 'master', an fp32 copy of the parameters."""
    _refuse_mesh_options(config)
    sdtype = DTYPES[config.state_dtype]
    device = tree_leaves(params)[0].device
    state = {"m": tree_map(lambda p: torch.zeros_like(p, dtype=sdtype),
                           params),
             "v": tree_map(lambda p: torch.zeros_like(p, dtype=sdtype),
                           params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if config.master_fp32:
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


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
    Returns (params, state, {'lr', 'grad_norm'})."""
    _refuse_mesh_options(config)
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
        p.copy_(new.to(p.dtype))

    tree_map(upd, ref, grads, state["m"], state["v"], params,
             reference_ndim(params))
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
