"""Mixture-of-Experts layer: top-k routing and capacity-based sort dispatch.

The counterpart of ``repro/models/moe.py`` (``init_moe``,
``_positions_in_expert``, ``moe_layer``), in the style of ``layers.py``:
plain functions of a dict of tensors, every tensor on its input's device.
The steps are the reference's, in its order and types:

  1. router: (T, D) @ (D, E) in fp32, softmax, top-k, the k gates
     renormalised; the Switch load-balance aux loss over each token's
     first choice;
  2. each routed slot's position among its expert's slots, from a stable
     sort (argsort + searchsorted);
  3. a scatter into an (E, C, D) capacity buffer, C = ceil(T·k/E ·
     capacity_factor); slots past C drop (Switch-style);
  4. the batched expert products, (E, C, D) @ (E, D, F), by ``torch.bmm``;
  5. the gathered outputs weighted by their gates and summed per token.

The reference leaves all of it to XLA: no Pallas kernel is on this path,
so the port's products, sorts and scatters are PyTorch's. Where the port
differs in how, not what:

* top-k is a stable descending sort cut to k, so ties go to the lower
  expert index first, ``jax.lax.top_k``'s order, on the CPU and the card
  alike (``torch.topk`` promises no order among ties on CUDA);
* the dispatch writes each kept slot's row to its (expert, position),
  pairs that are unique among the kept slots, and sends the dropped ones
  to a spare row past the buffer, which is then cut off; the reference
  adds the kept rows and zeros for the dropped ones into the buffer, which
  gives the same buffer. A plain write is deterministic and cheap on the
  card, where an accumulating scatter sorts its indices first (43 % of a
  4 x 1,024-token prefill's device time on the H100);
* the combine sums a token's k slots, which lie next to each other (slot
  t·k + j is token t's j-th choice), as a (T, k, D) sum over k where the
  reference takes a segment sum: no atomics, so it is deterministic on the
  card.

Under a mesh (``x`` a DTensor) the route runs on the tokens made whole
on every rank, where DTensor has no sharding strategy for the sort and
the ``searchsorted`` of step 2 nor for the dispatch's writes: every rank
routes the whole batch, as the reference's global capacity asks, and the
capacity buffer and the expert products are constrained to ('experts',
'expert_cap', 'embed'/'ff'), as the reference's are; the combine reads the
whole expert output again. The reference's ``padded_experts`` and
``moe_layer_a2a`` (the all-to-all over an expert mesh) come later
(ROADMAP Queue 1 item 9c); without a mesh the reference falls back to
``moe_layer``, which is what the port runs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import activation, normal_init
from repro_torch.parallel.sharding import (is_dtensor, logical_constraint,
                                           replicated, whole)


def init_moe(gen: torch.Generator, config: ModelConfig,
             dtype: torch.dtype) -> dict:
    """The router (D, E) in fp32, ``w_gate`` and ``w_up`` (E, D, F) and
    ``w_down`` (E, F, D) in ``dtype``, with the reference's std."""
    d, f, e = config.d_model, config.d_ff, config.num_experts
    std_in = 1.0 / math.sqrt(d)
    std_out = 1.0 / math.sqrt(f) / math.sqrt(2.0 * config.num_layers)
    return {"router": normal_init(gen, (d, e), std_in, torch.float32),
            "w_gate": normal_init(gen, (e, d, f), std_in, dtype),
            "w_up": normal_init(gen, (e, d, f), std_in, dtype),
            "w_down": normal_init(gen, (e, f, d), std_out, dtype)}


def moe_specs(config: ModelConfig) -> dict:
    """Logical axes of ``init_moe``'s tree: the reference's, whose
    ``_moe_impl == "a2a"`` override puts whole experts on ('model',
    'data')."""
    a2a = config.sharding_overrides.get("_moe_impl") == "a2a"
    ax = "experts_a2a" if a2a else "experts"
    in_ax = "null" if a2a else "expert_in"
    return {"router": ("embed", "null"), "w_gate": (ax, in_ax, "ff"),
            "w_up": (ax, in_ax, "ff"), "w_down": (ax, "ff", in_ax)}


def _positions_in_expert(expert_idx: torch.Tensor,
                         num_experts: int) -> torch.Tensor:
    """Rank of each routed slot within its expert, via a stable sort.

    expert_idx: (N,) integer -> (N,) position (0-based) among the slots
    routed to the same expert, ordered by original index."""
    n = expert_idx.shape[0]
    order = torch.argsort(expert_idx, stable=True)
    sorted_e = expert_idx[order]
    first = torch.searchsorted(
        sorted_e, torch.arange(num_experts, device=expert_idx.device,
                               dtype=sorted_e.dtype), side="left")
    pos_sorted = torch.arange(n, device=expert_idx.device) - first[sorted_e]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos


def route(xt: torch.Tensor, router: torch.Tensor, k: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt: (T, D) -> the router's probabilities (T, E) in fp32, and each
    token's top ``k`` gates, renormalised, and experts (T, k), the largest
    first and ties to the lower expert index."""
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    gates, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, top_idx = gates[:, :k], top_idx[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, top_idx


def capacity(tokens: int, config: ModelConfig) -> int:
    """Slots an expert takes: the reference's expression, in its order."""
    return int(max(1, math.ceil(tokens * config.experts_per_token
                                / config.num_experts
                                * config.capacity_factor)))


def moe_layer(x: torch.Tensor, params: dict, config: ModelConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, the aux loss, an fp32
    scalar)."""
    B, S, D = x.shape
    E, K = config.num_experts, config.experts_per_token
    T = B * S
    mesh = x.device_mesh if is_dtensor(x) else None
    xt = whole(x).reshape(T, D)

    # -- router (fp32) and the Switch-style load-balance aux loss ----------
    probs, gates, top_idx = route(xt, whole(params["router"]), K)
    density = F.one_hot(top_idx[:, 0], E).float().mean(0)
    router_mean = probs.mean(0)
    aux = (density * router_mean).sum() * E * config.router_aux_loss

    # -- dispatch -----------------------------------------------------------
    cap = capacity(T, config)
    slot_expert = top_idx.reshape(-1)                           # (T*K,)
    slot_token = torch.arange(T, device=x.device).repeat_interleave(K)
    slot_gate = gates.reshape(-1)
    pos = _positions_in_expert(slot_expert, E)                  # (T*K,)
    keep = pos < cap
    safe_pos = torch.where(keep, pos, cap - 1)
    rows = torch.where(keep, slot_expert * cap + pos, E * cap)
    buf = xt.new_zeros((E * cap + 1, D))        # + the dropped slots' row
    buf[rows] = xt[slot_token]
    buf = buf[:E * cap].view(E, cap, D)
    if mesh is not None:
        buf = logical_constraint(replicated(buf, mesh), "experts",
                                 "expert_cap", "embed")

    # -- expert compute (batched products) ----------------------------------
    dtype = x.dtype
    up = torch.bmm(buf, params["w_up"].to(dtype))
    gate = torch.bmm(buf, params["w_gate"].to(dtype))
    h = activation(gate, config.hidden_act) * up
    h = logical_constraint(h, "experts", "expert_cap", "ff")
    out_buf = whole(torch.bmm(h, params["w_down"].to(dtype)))  # (E, C, D)

    # -- combine --------------------------------------------------------------
    slot_out = torch.where(keep[:, None], out_buf[slot_expert, safe_pos], 0)
    combined = (slot_out * slot_gate[:, None].to(dtype)).view(T, K, D).sum(1)
    out = combined.reshape(B, S, D).to(x.dtype)
    if mesh is not None:
        # back to DTensors, so that their gradients come back as local
        # tensors through ``whole``
        out = logical_constraint(replicated(out, mesh), "batch", "seq",
                                 "embed")
        aux = replicated(aux, mesh)
    return out, aux
