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
whole expert output again.

``moe_layer_dropless`` is the port's own path, for a config with
``moe_dropless`` (mellum2-12b-a2.5b), which the reference does not have:
the same router, the token-slots sorted by expert, and each expert's
product over its own contiguous rows, so that no slot drops and no
buffer is sized by a capacity.

``moe_layer_a2a`` is the reference's explicit all-to-all expert
parallelism, which the ``_moe_impl: "a2a"`` override selects: experts
padded to a multiple of ``_moe_pad_experts`` (``padded_experts``), each
rank of the ('model', 'data') expert group owning whole experts,
model-major (``parallel/sharding.py``'s ``MODEL_MAJOR``), each rank
routing its own tokens with one all-to-all out and one back a buffer,
on ``torch.distributed``'s ``all_to_all_single`` over the expert group;
without a mesh, an expert axis larger than 1 or an even split of the
experts it falls back to ``moe_layer``, as the reference does.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.metrics import fine_span, get_registry
from repro_torch.models.layers import activation, normal_init
from repro_torch.parallel.sharding import (MODEL_MAJOR, P, current_mesh,
                                           is_dtensor, local_shard,
                                           logical_constraint, mesh_axes,
                                           placements, redistribute,
                                           replicated, whole)


def padded_experts(config: ModelConfig) -> int:
    """E rounded up to a multiple of ``_moe_pad_experts`` when the config
    takes the all-to-all path, so that each device owns whole experts
    (kimi-k2: 384 -> 512 on 256 devices); E otherwise."""
    pad_to = int(config.sharding_overrides.get("_moe_pad_experts", 0))
    if pad_to and config.sharding_overrides.get("_moe_impl") == "a2a":
        return -(-config.num_experts // pad_to) * pad_to
    return config.num_experts


def init_moe(gen: torch.Generator, config: ModelConfig,
             dtype: torch.dtype) -> dict:
    """The router (D, E) in fp32, ``w_gate`` and ``w_up`` (E_pad, D, F)
    and ``w_down`` (E_pad, F, D) in ``dtype``, with the reference's std;
    E_pad is ``padded_experts``, and the router never routes a padded
    expert."""
    d, f, e = config.d_model, config.d_ff, padded_experts(config)
    std_in = 1.0 / math.sqrt(d)
    std_out = 1.0 / math.sqrt(f) / math.sqrt(2.0 * config.num_layers)
    return {"router": normal_init(gen, (d, config.num_experts), std_in,
                                  torch.float32),
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


def _top1_onehot(top_idx: torch.Tensor, E: int) -> torch.Tensor:
    """Each token's first choice one-hot over the E experts, fp32: the
    values of ``F.one_hot``, without its check of the indices' range (a
    read of the data, which a trace on fake tensors cannot make)."""
    experts = torch.arange(E, device=top_idx.device)
    return (top_idx[:, :1] == experts).float()


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
    density = _top1_onehot(top_idx, E).mean(0)
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


# -- dropless routing -----------------------------------------------------------
COMBINE_CHUNK = 16_384          # tokens a step of the dropless combine
# up to this many tokens a call (a decode step's batch), every expert runs
# over every token in one batched product: the call is bound by reading
# the experts' weights, which both ways read, and needs no host sync
DENSE_TOKENS = 64


def _combine(out: torch.Tensor, gates: torch.Tensor, dtype: torch.dtype
             ) -> torch.Tensor:
    """(T, K, D) slot outputs weighed by their (T, K) fp32 gates and summed
    over K in fp32, ``COMBINE_CHUNK`` tokens at a time -> (T, D)."""
    T, _, D = out.shape
    combined = torch.empty((T, D), dtype=dtype, device=out.device)
    for c in range(0, T, COMBINE_CHUNK):
        part = slice(c, c + COMBINE_CHUNK)
        combined[part] = (out[part].float() * gates[part, :, None]
                          ).sum(1).to(dtype)
    return combined


def _swiglu(rows: torch.Tensor, params: dict, e, config: ModelConfig
            ) -> torch.Tensor:
    """Expert ``e``'s product over ``rows`` (an index, or a full slice for
    every expert at once by ``torch.matmul``'s batching)."""
    dtype = rows.dtype
    h = activation(torch.matmul(rows, params["w_gate"][e].to(dtype)),
                   config.hidden_act) * torch.matmul(
        rows, params["w_up"][e].to(dtype))
    return torch.matmul(h, params["w_down"][e].to(dtype))


def moe_layer_dropless(x: torch.Tensor, params: dict, config: ModelConfig
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, the aux loss): the
    MoE with no slot dropped, for a config with ``moe_dropless``.

    The router and the aux loss are ``moe_layer``'s (``route``: the fp32
    softmax, the top k, the gates renormalised). Past ``DENSE_TOKENS``
    tokens, the T·k token-slots are sorted by expert (a stable sort, so
    each expert's rows keep token order), the rows gathered into one
    (T·k, D) block in that order, and each expert's SwiGLU product runs
    over its own contiguous rows, its result written back to its slots'
    rows (pairs unique, so no accumulation); the rows an expert takes are
    read on the host (one sync a call) to cut the block. Up to
    ``DENSE_TOKENS`` tokens every expert runs over every token in one
    batched product, (E, T, D) @ (E, D, F), and each slot takes its
    expert's row. The combine weighs a token's k slots by their gates and
    sums them in fp32 (``_combine``). No buffer grows with the experts
    times a capacity: an expert that every token picks computes all T of
    its rows.

    The port's counter ``moe_rows_total`` adds the call's T·k slots, and
    a sorted call sets the gauge ``moe_expert_rows_max`` to its largest
    expert's rows. Each step is a fine device span: ``moe_route``,
    ``moe_dispatch`` (sorted calls), ``moe_experts`` (``attrs`` rows, the
    slots), ``moe_combine``."""
    if is_dtensor(x):
        raise ValueError("moe_layer_dropless runs on plain tensors; under a "
                         "mesh take moe_layer or moe_layer_a2a")
    B, S, D = x.shape
    E, K = config.num_experts, config.experts_per_token
    T = B * S
    xt = x.reshape(T, D)
    with fine_span("moe_route", device=True):
        probs, gates, top_idx = route(xt, params["router"], K)
        density = _top1_onehot(top_idx, E).mean(0)
        aux = (density * probs.mean(0)).sum() * E * config.router_aux_loss
    reg = get_registry()
    reg.counter("moe_rows_total",
                "token-slots the dropless MoE computed").inc(T * K)
    if T <= DENSE_TOKENS:
        with fine_span("moe_experts", device=True, attrs={"rows": T * K}):
            every = _swiglu(xt.expand(E, T, D), params, slice(None), config)
        with fine_span("moe_combine", device=True):
            tokens = torch.arange(T, device=x.device)[:, None]
            out = _combine(every[top_idx, tokens], gates, x.dtype)
        return out.view(B, S, D), aux
    with fine_span("moe_dispatch", device=True):
        slot_expert = top_idx.reshape(-1)                       # (T*K,)
        order = torch.argsort(slot_expert, stable=True)
        counts = torch.bincount(slot_expert, minlength=E).tolist()
        rows = xt[order // K]            # slot s is token s // K's
    reg.gauge("moe_expert_rows_max",
              "the largest expert's rows in the last sorted dropless MoE "
              "call").set(max(counts))
    with fine_span("moe_experts", device=True, attrs={"rows": T * K}):
        out = torch.empty_like(rows)
        start = 0
        for e, n in enumerate(counts):
            if n:
                out[order[start:start + n]] = _swiglu(
                    rows[start:start + n], params, e, config)
            start += n
        del rows
    with fine_span("moe_combine", device=True):
        out = _combine(out.view(T, K, D), gates, x.dtype)
    return out.view(B, S, D), aux


# -- explicit all-to-all expert parallelism -------------------------------------
# The reference's shard_map refuses tokens that do not split over its
# in_specs (a decode's S = 1 over a 'model' axis larger than 1, say): run
# on 8 virtual devices at (data 4, model 2), its decode raises ValueError
A2A_REFUSED = (
    "moe_layer_a2a: tokens of shape {shape} do not split over the mesh's "
    "{spec} (sizes {sizes}); each rank routes its own block of tokens, "
    "and the reference's shard_map refuses such a split (a decode's one "
    "position over a 'model' axis larger than 1 among them)")


def _expert_group(mesh, axes: tuple[str, ...]) -> tuple:
    """The process group of this rank's expert group, the ranks that share
    its coordinates off ``axes`` (its pod), and ``owner``: owner[j] is the
    expert block (``axes``' coordinates, the first the most significant,
    the reference's ``axis_index(axes)``) of the group's rank j. A group
    over one axis is the mesh's own; one over two is made once for the
    mesh, by every rank, and kept on the mesh."""
    import torch.distributed as dist

    groups = mesh.__dict__.setdefault("_expert_groups", {})
    if axes in groups:
        return groups[axes]
    names = list(mesh.mesh_dim_names)
    keep = [names.index(a) for a in axes]
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    else:
        rest = [i for i in range(len(names)) if i not in keep]
        blocks = mesh.mesh.permute(*rest, *keep).reshape(
            -1, math.prod(mesh.mesh.shape[i] for i in keep))
        group, _ = dist.new_subgroups_by_enumeration(blocks.tolist())

    def block(rank: int) -> int:
        coord = (mesh.mesh == rank).nonzero()[0].tolist()
        b = 0
        for i in keep:
            b = b * mesh.mesh.shape[i] + coord[i]
        return b

    groups[axes] = group, [block(r)
                           for r in dist.get_process_group_ranks(group)]
    return groups[axes]


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all of a (n, ...) buffer over the expert group:
    block i goes to expert block i, and block i of the result came from
    expert block i. Its transpose is itself, so the backward pass sends
    each gradient block back where its rows came from."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any, owner: list
                ) -> torch.Tensor:
        ctx.group, ctx.owner = group, owner
        return _all_to_all(x, group, owner)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _all_to_all(g, ctx.group, ctx.owner), None, None


def _all_to_all(x: torch.Tensor, group: Any, owner: list) -> torch.Tensor:
    import torch.distributed as dist

    ident = owner == sorted(owner)
    send = x if ident else x[torch.tensor(owner, device=x.device)]
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send.contiguous(), group=group)
    if ident:
        return out
    back = torch.empty(len(owner), dtype=torch.long)
    back[torch.tensor(owner)] = torch.arange(len(owner))
    return out[back.to(x.device)]


class _GroupMean(torch.autograd.Function):
    """The mean over the expert group (the reference's ``pmean``) of a
    tensor each rank computes from its own tokens. The result is the same
    on every rank of the group and its gradient arrives so: the gradient of
    a rank's own term is the mean's, 1/n of it, with no communication."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any, n: int) -> torch.Tensor:
        import torch.distributed as dist

        ctx.n = n
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / n

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g / ctx.n, None, None


def _local(t: torch.Tensor, mesh, places: tuple, grad_places=None
           ) -> torch.Tensor:
    """This rank's block of ``t`` placed by ``places``: a DTensor's local
    tensor after a redistribute, whose gradient comes back on
    ``grad_places``; a plain tensor's block (``local_shard``)."""
    if is_dtensor(t):
        return redistribute(t, mesh, places).to_local(
            grad_placements=grad_places)
    return local_shard(t, mesh, places)


def _partial_where_replicated(places: tuple, mesh) -> tuple:
    """``places`` with a pending sum on every mesh dimension larger than 1
    that replicates: the gradient of a tensor each rank uses on its own
    tokens is the sum of the ranks' parts there."""
    from torch.distributed.tensor import Partial, Replicate

    sizes = list(mesh_axes(mesh).values())
    return tuple(Partial() if isinstance(p, Replicate) and n > 1 else p
                 for p, n in zip(places, sizes))


def moe_layer_a2a(x: torch.Tensor, params: dict, config: ModelConfig
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``moe_layer_a2a``: x (B, S, D) -> (out, aux), MoE
    with hand-placed all-to-all routing on the active ``DeviceMesh``.

    Each rank of the expert group (the mesh's 'model' and 'data' axes of
    size > 1, model-major) owns E_pad/n whole experts and routes its own
    block of tokens, (B/|pod·data|, S/|model|, D): the router in fp32, the
    aux loss over the group's mean density and router mean; each routed
    slot goes to its expert's owner, at most ``cap = ceil(T_local·k/n ·
    capacity_factor)`` slots to a rank (the rest drop), the rows, their
    experts and their gates in three buffers, one all-to-all each; the
    owner puts what it received into (E_pad/n, n·cap, D), no second drop,
    runs its experts by ``torch.bmm``, weights each row by its gate and
    sends it back, one all-to-all; each rank sums its tokens' slots in
    fp32. The buffers are written as ``moe_layer``'s is, each kept slot to
    its own row. The result is a DTensor of those blocks and the aux loss
    a replicated one; gradients flow back through the reverse all-to-alls.
    Without a mesh, with no expert axis larger than 1, or when E_pad does
    not split over the group, ``moe_layer``; tokens that do not split
    over the mesh are refused (``A2A_REFUSED``)."""
    from torch.distributed.tensor import DTensor

    mesh = current_mesh()
    if mesh is None:
        return moe_layer(x, params, config)
    sizes = mesh_axes(mesh)
    # expert ownership follows the 'experts_a2a' rule's order, MODEL_MAJOR
    axes = tuple(a for a in MODEL_MAJOR if sizes.get(a, 1) > 1)
    if not axes:
        return moe_layer(x, params, config)
    n_dev = math.prod(sizes[a] for a in axes)
    E_pad = params["w_up"].shape[0]
    if E_pad % n_dev:
        return moe_layer(x, params, config)
    e_per = E_pad // n_dev
    E, K = config.num_experts, config.experts_per_token

    # x arrives (batch@[pod,]data, act_seq@model); the weights are per-rank
    # expert blocks, replicated over 'pod' (pod stays pure data parallel)
    bspec = tuple(a for a in ("pod", "data") if a in sizes)
    x_spec = P(bspec or None, "model" if "model" in sizes else None)
    split = [math.prod(sizes[a] for a in bspec),
             sizes.get("model", 1)]
    if x.shape[0] % split[0] or x.shape[1] % split[1]:
        raise ValueError(A2A_REFUSED.format(shape=tuple(x.shape),
                                            spec=tuple(x_spec), sizes=sizes))
    x_places = placements(x_spec, mesh)
    w_places = placements(P(tuple(a for a in MODEL_MAJOR if a in sizes)),
                          mesh)
    router_places = placements(P(), mesh)
    group, owner = _expert_group(mesh, axes)
    me = owner[torch.distributed.get_rank(group)]

    xl = _local(x, mesh, x_places)
    router = _local(params["router"], mesh, router_places,
                    _partial_where_replicated(router_places, mesh))
    w = {k: _local(params[k], mesh, w_places,
                   _partial_where_replicated(w_places, mesh))
         for k in ("w_gate", "w_up", "w_down")}

    B, S, D = xl.shape
    T = B * S
    xt = xl.reshape(T, D)
    probs, gates, top_idx = route(xt, router, K)
    density = _GroupMean.apply(_top1_onehot(top_idx, E).mean(0), group,
                               n_dev)
    router_mean = _GroupMean.apply(probs.mean(0), group, n_dev)
    aux = (density * router_mean).sum() * E * config.router_aux_loss

    # -- route each slot to its expert's owner ------------------------------
    slot_expert = top_idx.reshape(-1)                           # (T*K,)
    slot_token = torch.arange(T, device=xl.device).repeat_interleave(K)
    slot_gate = gates.reshape(-1).float()
    dest = slot_expert // e_per                                 # owner
    cap = int(max(1, math.ceil(T * K / n_dev * config.capacity_factor)))
    pos = _positions_in_expert(dest, n_dev)
    keep = pos < cap
    safe_pos = torch.where(keep, pos, cap - 1)
    rows = torch.where(keep, dest * cap + pos, n_dev * cap)    # + a spare
    send_x = xt.new_zeros((n_dev * cap + 1, D))
    send_x[rows] = xt[slot_token]
    send_e = torch.full((n_dev * cap + 1,), -1, dtype=torch.int32,
                        device=xl.device)
    send_e[rows] = slot_expert.to(torch.int32)
    send_g = torch.zeros(n_dev * cap + 1, dtype=torch.float32,
                         device=xl.device)
    send_g[rows] = slot_gate

    recv_x = _AllToAll.apply(send_x[:-1].view(n_dev, cap, D), group, owner)
    with torch.no_grad():
        recv_e = _all_to_all(send_e[:-1].view(n_dev, cap), group, owner)
    recv_g = _AllToAll.apply(send_g[:-1].view(n_dev, cap), group, owner)
    R = n_dev * cap
    rx = recv_x.reshape(R, D)
    le = recv_e.reshape(R).long() - me * e_per                  # local id
    valid = (le >= 0) & (le < e_per)

    # -- the local re-dispatch into (e_per, R, D): no second drop ------------
    le_safe = torch.where(valid, le, e_per - 1)
    lrows = le_safe * R + _positions_in_expert(le_safe, e_per)
    buf = rx.new_zeros((e_per * R, D))
    buf[lrows] = torch.where(valid[:, None], rx, 0)
    buf = buf.view(e_per, R, D)
    dtype = xl.dtype
    up = torch.bmm(buf, w["w_up"].to(dtype))
    gate = torch.bmm(buf, w["w_gate"].to(dtype))
    h = activation(gate, config.hidden_act) * up
    out_buf = torch.bmm(h, w["w_down"].to(dtype)).view(e_per * R, D)
    ry = torch.where(valid[:, None], out_buf[lrows], 0)
    ry = ry * recv_g.reshape(R, 1).to(dtype)
    back = _AllToAll.apply(ry.view(n_dev, cap, D), group, owner)

    # -- combine, in fp32 ------------------------------------------------------
    slot_out = torch.where(keep[:, None],
                           back.view(R, D)[dest * cap + safe_pos], 0)
    combined = slot_out.float().view(T, K, D).sum(1)
    out = combined.reshape(B, S, D).to(xl.dtype)
    return (DTensor.from_local(out, mesh, x_places, run_check=False),
            replicated(aux, mesh))
