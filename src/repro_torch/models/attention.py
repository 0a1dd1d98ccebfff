"""Attention: GQA/MQA/MHA with RoPE, causal self-attention (with or without
a sliding window), non-causal self-attention and cross-attention
(whisper), and the serve path's KV cache.

The counterpart of ``repro/models/attention.py``. Four implementations of
one function, chosen by ``attention_impl`` and the call
(``attention_core``, the reference's branches in the reference's order,
``attention.py:253-269``):

* ``flash``      — the CUDA flash kernel (``kernels/flash_attention``), the
                   reference's ``pallas``: taken for a causal, window-free
                   call with Sq > 1 on the card. The default.
* ``naive``      — the full score matrix in fp32; the oracle, and what a
                   call takes under ``naive``, at Sq = 1 (decode), or at
                   Sq <= ``attention_block_q`` whatever the impl.
* ``triangular`` — the causal schedule that issues only the (q, kv) tiles
                   on or below the diagonal (and inside the window), for a
                   causal self-attention past ``attention_block_q``.
* ``blocked``    — the online softmax over (``attention_block_q`` x
                   ``attention_block_kv``) tiles, every tile, or with the
                   ``_skip_blocks`` override only those that can hold an
                   unmasked pair: every other call past
                   ``attention_block_q`` (a window, a non-causal encoder,
                   a cross-attention, or a causal call on the CPU).

So, as in the reference, whisper's 1,500-frame encoder and
recurrentgemma's windowed 2,560-token prefill run ``blocked``, and a
train step, whose ``flash`` runs as ``blocked`` (``training.py``), runs
the tiles under autograd. On the CPU a causal prefill under ``flash``
takes the branches after the first, the plain versions of the kernel's
function. The tiles compute in fp32 and return ``q.dtype``; the reference
runs them as a ``lax.scan`` for XLA, the port as Python loops over static
block indices, so an unreachable tile is never issued.

Under a mesh (``parallel/sharding.py``) q, k and v are constrained to
('batch', 'seq', 'heads'/'kv_heads', 'head_dim') as the reference's are
(``attention.py:308-330``); a projection's output is constrained to its
head view's spec before the reshape into heads, so that a 'model' axis
that divides a weight's columns but not its head count leaves the heads
whole instead of meeting an uneven reshape. With
``pad_attention_heads``, when the mesh's 'model' axis is larger than 1
and does not divide H, q (and K/V after the repeat) are padded with zero
heads to the next multiple, and the padding is sliced off before the out
projection (``attention.py:312-331,381``); without a mesh no head is
padded. ``attention_core`` runs on each rank's own (batch, heads) block,
the flash kernel included (``_local_core``).

RoPE turns q and k only when ``config.pos_embedding == "rope"`` and the
call is not a cross-attention (whisper's learned positions are added to
its inputs instead). A cross-attention call (``kv_source`` or
``precomputed_kv``) attends to every encoder position, non-causal, and
returns its projected K/V so that the decode can reuse them.

The sliding window (``window`` > 0, recurrentgemma's local attention): a
query at p sees keys at p - window < q <= p; the cache holds
``min(window, max_len)`` slots, a prefill longer than that keeps its last
slots rotated so that position p sits in slot p % Smax, and a decode step
writes slot pos % Smax in place, each slot's absolute position recovered
from pos.

GQA: K/V are repeated to the full H query heads after RoPE, as the
reference does, so every attention tensor is (B, S, H, hd).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, Yarn
from repro_torch.data.metrics import fine_span
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import apply_rope, normal_init, seq_whole
from repro_torch.parallel.sharding import (current_mesh, current_rules,
                                           drop_indivisible, is_dtensor,
                                           like, local_shard,
                                           logical_constraint,
                                           mesh_size, model_degree,
                                           placements, redistribute, summed,
                                           whole)

NEG_INF = -1e30


# -- params ----------------------------------------------------------------------
def init_attention(gen: torch.Generator, config: ModelConfig,
                   dtype: torch.dtype) -> dict:
    d, h, kh = config.d_model, config.num_heads, config.num_kv_heads
    hd = config.resolved_head_dim
    std = 1.0 / math.sqrt(d)
    std_o = 1.0 / math.sqrt(h * hd) / math.sqrt(2.0 * config.num_layers)
    return {"wq": normal_init(gen, (d, h * hd), std, dtype),
            "wk": normal_init(gen, (d, kh * hd), std, dtype),
            "wv": normal_init(gen, (d, kh * hd), std, dtype),
            "wo": normal_init(gen, (h * hd, d), std_o, dtype)}


def attention_specs() -> dict:
    """Logical axes of ``init_attention``'s tree."""
    return {"wq": ("embed_fsdp", "heads"), "wk": ("embed_fsdp", "kv_heads"),
            "wv": ("embed_fsdp", "kv_heads"), "wo": ("heads", "embed_fsdp")}


# -- masking ---------------------------------------------------------------------
def _pair_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """(B, Sq, Skv) boolean mask. kpos < 0 marks padding/invalid slots."""
    valid = kpos[:, None, :] >= 0
    if causal:
        valid = valid & (kpos[:, None, :] <= qpos[:, :, None])
    if window > 0:
        valid = valid & (qpos[:, :, None] - kpos[:, None, :] < window)
    return valid


def _split_heads(x: torch.Tensor, n: int, hd: int,
                 axis: str = "heads") -> torch.Tensor:
    """(B, S, n·hd) -> (B, S, n, hd); under a mesh the projection first
    takes the spec of its head view, ('batch', 'seq', ``axis``) with the
    axes that do not divide n dropped."""
    mesh = current_mesh()
    if mesh is not None and mesh_size(mesh) > 1:
        view = tuple(x.shape[:-1]) + (n, hd)
        spec = drop_indivisible(current_rules().spec(
            ("batch", "seq", axis, "head_dim"), mesh), view, mesh)
        x = redistribute(x, mesh, placements(spec[:3], mesh))
    return x.reshape(x.shape[:-1] + (n, hd))


# -- naive (oracle) ------------------------------------------------------------------
def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    qpos: torch.Tensor, kpos: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q, k, v: (B, S, H, hd) (KV already repeated) -> (B, Sq, H, hd)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * scale
    mask = _pair_mask(qpos, kpos, causal, window)              # (B,Sq,Skv)
    s = s.masked_fill(~mask[:, None, :, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", p, v.float())
    return out.to(q.dtype)


# -- the tiled schedules ------------------------------------------------------------
def blocked_tiles(nq: int, nk: int, bq: int, bkv: int, causal: bool,
                  window: int, skip_blocks: bool) -> list[list[int]]:
    """For each of ``nq`` q blocks, the kv blocks that ``blocked_attention``
    issues: all ``nk``, or with ``skip_blocks`` those that can hold an
    unmasked pair by the blocks' static layout: not wholly in the future
    (causal) and not wholly before the window (the reference's
    reachability, ``attention.py:145-156``)."""
    tiles = []
    for qi in range(nq):
        row = []
        for kj in range(nk):
            q_lo, k_lo = qi * bq, kj * bkv
            future = causal and k_lo > q_lo + bq - 1
            before = window > 0 and q_lo - (k_lo + bkv - 1) >= window
            if not (skip_blocks and (future or before)):
                row.append(kj)
        tiles.append(row)
    return tiles


def triangular_tiles(n: int, block: int, window: int) -> list[list[int]]:
    """For each of ``n`` blocks of queries, the key blocks that
    ``triangular_attention`` issues: those on or below the diagonal and,
    with a window, not wholly before it (the reference's pair list,
    ``attention.py:210-211``, in its order)."""
    return [[ki for ki in range(qi + 1)
             if window <= 0 or qi * block - (ki * block + block - 1) < window]
            for qi in range(n)]


def _blocks(x: torch.Tensor, n: int, b: int) -> torch.Tensor:
    """(B, S, H, hd) as fp32 (B, H, n·b, hd), zero-padded at the end."""
    x = x.float().transpose(1, 2)
    if n * b > x.shape[2]:
        x = torch.nn.functional.pad(x, (0, 0, 0, n * b - x.shape[2]))
    return x.contiguous()


def _block_pos(pos: torch.Tensor, n: int, b: int) -> torch.Tensor:
    """(B, S) positions padded to n·b with -1, which masks them."""
    if n * b > pos.shape[1]:
        pos = torch.nn.functional.pad(pos, (0, n * b - pos.shape[1]),
                                      value=-1)
    return pos


def _tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
           window: int, bq: int, bkv: int, tiles: list[list[int]]
           ) -> torch.Tensor:
    """The online softmax of each q block over its kv blocks ``tiles[qi]``,
    in order: m, l and acc per q block, updated in the reference's order
    (m_new, p, alpha, l_new, acc_new), then acc / max(l, 1e-30). A q row
    whose first tiles are wholly masked sums exp(0) over them; the first
    tile that holds a key for it sets alpha = exp(-1e30 - m) = 0 and erases
    that sum (NEG_INF is finite, so no inf - inf makes a NaN).

    The running max is taken without a gradient: the output does not
    depend on it (it cancels between acc and l), so its derivative is zero
    in exact arithmetic, and autograd keeps only each tile's p, not its
    scores as well. ``jax.grad`` of the reference differentiates through
    the max, which adds terms that cancel to round-off."""
    B, Sq, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    nq, nk = len(tiles), -(-k.shape[1] // bkv)
    qb, qpos = _blocks(q, nq, bq), _block_pos(qpos, nq, bq)
    kb, vb = _blocks(k, nk, bkv), _blocks(v, nk, bkv)
    kpos = _block_pos(kpos, nk, bkv)
    out = []
    for qi, row in enumerate(tiles):
        q_i = qb[:, :, qi * bq:(qi + 1) * bq]
        qp_i = qpos[:, qi * bq:(qi + 1) * bq]
        m = q_i.new_full((B, H, bq), NEG_INF)
        l = q_i.new_zeros((B, H, bq))
        acc = q_i.new_zeros((B, H, bq, hd))
        for kj in row:
            ks = slice(kj * bkv, (kj + 1) * bkv)
            s = torch.matmul(q_i, kb[:, :, ks].transpose(-1, -2)) * scale
            mask = _pair_mask(qp_i, kpos[:, ks], causal, window)
            s = s.masked_fill(~mask[:, None, :, :], NEG_INF)
            m_new = torch.maximum(m, s.detach().amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.matmul(p, vb[:, :, ks])
            m = m_new
        out.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return torch.cat(out, dim=2).transpose(1, 2)[:, :Sq]


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      qpos: torch.Tensor, kpos: torch.Tensor,
                      causal: bool = True, window: int = 0,
                      block_q: int = 512, block_kv: int = 1024,
                      skip_blocks: bool = False) -> torch.Tensor:
    """q: (B, Sq, H, hd), k, v: (B, Skv, H, hd) (KV already repeated) ->
    (B, Sq, H, hd): the naive function over (block_q x block_kv) tiles,
    every tile or, with ``skip_blocks``, the reachable ones
    (``blocked_tiles``). A fine span, ``blocked_attention``."""
    with fine_span("blocked_attention"):
        bq, bkv = min(block_q, q.shape[1]), min(block_kv, k.shape[1])
        nq, nk = -(-q.shape[1] // bq), -(-k.shape[1] // bkv)
        tiles = blocked_tiles(nq, nk, bq, bkv, causal, window, skip_blocks)
        return _tiled(q, k, v, qpos, kpos, causal, window, bq, bkv, tiles)


def triangular_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         qpos: torch.Tensor, kpos: torch.Tensor,
                         causal: bool = True, window: int = 0,
                         block: int = 512) -> torch.Tensor:
    """Causal self-attention (Sq == Skv) over (block x block) tiles that
    issues only the tiles on or below the diagonal and inside the window
    (``triangular_tiles``): n(n+1)/2 of n² without a window."""
    Sq = q.shape[1]
    if Sq != k.shape[1]:
        raise ValueError(f"the triangular schedule is for self-attention: "
                         f"Sq {Sq} != Skv {k.shape[1]}")
    b = min(block, Sq)
    tiles = triangular_tiles(-(-Sq // b), b, window)
    return _tiled(q, k, v, qpos, kpos, causal, window, b, b, tiles)


# -- dispatch --------------------------------------------------------------------
ATTENTION_IMPLS = ("flash", "naive", "blocked", "triangular")


def _local_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                qpos: torch.Tensor, kpos: torch.Tensor, config: ModelConfig,
                causal: bool, window: int) -> torch.Tensor:
    """``attention_core`` of DTensors on each rank's own (batch, heads)
    block, which holds every pair it attends: k and v take q's
    placements, which may shard only the batch and the heads, the
    positions this rank's rows, and the output keeps q's placements. So
    the flash kernel, the naive form and the tiles each run on plain
    tensors, as ``local_map`` would run them."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, places = q.device_mesh, summed(q.placements)
    if any(not (isinstance(p, Replicate) or (isinstance(p, Shard)
                                             and p.dim in (0, 2)))
           for p in places):
        raise ValueError(f"attention on DTensors shards only the batch "
                         f"and the heads; q is placed {places}")
    q, k, v = (redistribute(t, mesh, places) for t in (q, k, v))
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in places]
    qpos, kpos = (local_shard(whole(t), mesh, rows) for t in (qpos, kpos))
    out = attention_core(q.to_local(), k.to_local(), v.to_local(), qpos,
                         kpos, config, causal, window)
    return DTensor.from_local(out, mesh, places, run_check=False)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   qpos: torch.Tensor, kpos: torch.Tensor,
                   config: ModelConfig, causal: bool = True,
                   window: int = 0) -> torch.Tensor:
    """The reference's dispatch (``attention.py:253-269``), branch for
    branch, with ``flash`` for its ``pallas`` and the kernel taken only on
    the card."""
    impl = config.attention_impl
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention_impl={impl!r}: one of "
                         f"{ATTENTION_IMPLS}")
    if is_dtensor(q):
        return _local_core(q, k, v, qpos, kpos, config, causal, window)
    Sq = q.shape[1]
    if impl == "flash" and causal and window == 0 and Sq > 1 and q.is_cuda:
        # like the reference's Pallas call, qpos/kpos are not read: the
        # causal prefill's positions are 0..S-1 on both sides
        return fa_ops.flash_attention(q, k, v)
    if impl == "naive" or Sq == 1 or Sq <= config.attention_block_q:
        return naive_attention(q, k, v, qpos, kpos, causal, window)
    if impl == "triangular" and causal and Sq == k.shape[1]:
        return triangular_attention(q, k, v, qpos, kpos, causal, window,
                                    block=config.attention_block_q)
    return blocked_attention(
        q, k, v, qpos, kpos, causal, window,
        block_q=config.attention_block_q, block_kv=config.attention_block_kv,
        skip_blocks=config.sharding_overrides.get("_skip_blocks", False))


def attention_layer(x: torch.Tensor, params: dict, config: ModelConfig,
                    positions: torch.Tensor, cache: dict | None = None,
                    kv_source: torch.Tensor | None = None,
                    precomputed_kv: tuple[torch.Tensor, torch.Tensor]
                    | None = None,
                    causal: bool = True, window: int = 0,
                    yarn: Yarn | None = None
                    ) -> tuple[torch.Tensor, dict | None]:
    """Attention layer: qkv projections, RoPE (``yarn``'s when given),
    core, out projection.

    ``cache`` (prefill/decode): dict with 'k', 'v' (B, Smax, KH, hd) buffers
    and 'pos' (tokens already cached, an int). The buffers are updated in
    place (the reference returns new arrays), and the returned cache holds
    them with ``pos`` advanced. Prefill (S > 1) attends over the fresh
    sequence, then fills the cache; decode (S == 1) writes its slot, then
    attends over the filled slots. ``window`` > 0 makes the attention a
    sliding window and the cache a rolling buffer (module docstring).
    ``kv_source`` (B, T, D) makes the call a cross-attention whose keys and
    values are projected from it; ``precomputed_kv`` (each (B, T, KH, hd))
    reuses keys and values projected before. A cross call sees every one
    of the T positions and returns {'k', 'v'}, the projected (or reused)
    keys and values, as its cache."""
    B, S, _ = x.shape
    h, kh = config.num_heads, config.num_kv_heads
    hd = config.resolved_head_dim
    g = h // kh
    dtype = x.dtype
    x = seq_whole(x)
    if kv_source is not None:
        kv_source = seq_whole(kv_source)

    q = _split_heads(x @ params["wq"].to(dtype), h, hd)
    if precomputed_kv is not None:
        k, v = precomputed_kv
    else:
        src = x if kv_source is None else kv_source
        k = _split_heads(src @ params["wk"].to(dtype), kh, hd, "kv_heads")
        v = _split_heads(src @ params["wv"].to(dtype), kh, hd, "kv_heads")
    cross = kv_source is not None or precomputed_kv is not None
    if config.pos_embedding == "rope" and not cross:
        q = apply_rope(q, positions, config.rope_theta, yarn)
        k = apply_rope(k, positions, config.rope_theta, yarn)
    q = logical_constraint(q, "batch", "seq", "heads", "head_dim")
    k = logical_constraint(k, "batch", "seq", "kv_heads", "head_dim")
    v = logical_constraint(v, "batch", "seq", "kv_heads", "head_dim")

    # head padding: zero heads up to a multiple of the 'model' axis, so
    # that the heads shard instead of every rank computing all of them
    m = model_degree()
    pad_h = (-h) % m if config.pad_attention_heads and m > 1 else 0
    if pad_h:
        q = logical_constraint(torch.nn.functional.pad(
            q, (0, 0, 0, pad_h)), "batch", "seq", "heads", "head_dim")

    def rep(t: torch.Tensor) -> torch.Tensor:
        # repeat KV to the full H heads (the reference's 4-D layout)
        t = torch.repeat_interleave(t, g, dim=2) if g > 1 else t
        if pad_h:
            t = torch.nn.functional.pad(t, (0, 0, 0, pad_h))
        return logical_constraint(t, "batch", "seq", "heads", "head_dim")

    new_cache = None
    if cross:
        # every encoder position is visible
        kpos = torch.arange(k.shape[1], device=x.device).expand(B, -1)
        out = attention_core(q, rep(k), rep(v), positions, kpos, config,
                             causal=False)
        new_cache = {"k": k, "v": v}
    elif cache is None:
        out = attention_core(q, rep(k), rep(v), positions, positions, config,
                             causal=causal, window=window)
    elif S > 1:
        out = attention_core(q, rep(k), rep(v), positions, positions, config,
                             causal=causal, window=window)
        ck, cv, pos = cache["k"], cache["v"], cache["pos"]
        Smax = ck.shape[1]
        if window > 0 and S >= Smax:
            # keep the last window, rotated so that slot(p) == p % Smax
            shift = (S - Smax) % Smax
            ck.copy_(like(torch.roll(k[:, S - Smax:], shift, dims=1), ck))
            cv.copy_(like(torch.roll(v[:, S - Smax:], shift, dims=1), cv))
        else:
            n = min(S, Smax)
            start = min(max(pos, 0), Smax - n)  # dynamic_update_slice's clamp
            ck[:, start:start + n] = like(k[:, :n].to(ck.dtype), ck)
            cv[:, start:start + n] = like(v[:, :n].to(cv.dtype), cv)
        new_cache = {"k": ck, "v": cv, "pos": pos + S}
    else:
        # decode; with a window the buffer wraps in place. The slot write,
        # the repeated cache and the core are the device span
        # ``decode_attention``, its ``kind`` sliding or full.
        with fine_span("decode_attention", device=True,
                       attrs={"kind": "sliding" if window > 0 else "full"}):
            ck, cv, pos = cache["k"], cache["v"], cache["pos"]
            Smax = ck.shape[1]
            slot = pos % Smax if window > 0 else min(pos, Smax - 1)
            ck[:, slot:slot + 1] = like(k.to(ck.dtype), ck)
            cv[:, slot:slot + 1] = like(v.to(cv.dtype), cv)
            # absolute positions of the cache slots; -1 marks not-yet-filled
            idx = torch.arange(Smax, device=x.device)
            if window > 0:
                abs_pos = idx + torch.div(pos - idx, Smax,
                                          rounding_mode="floor") * Smax
                kpos_row = torch.where((abs_pos >= 0) & (abs_pos <= pos),
                                       abs_pos, -1)
            else:
                kpos_row = torch.where(idx <= pos, idx, -1)
            kpos = kpos_row.expand(B, Smax)
            out = attention_core(q, rep(ck), rep(cv), positions, kpos,
                                 config, causal=True, window=window)
        new_cache = {"k": ck, "v": cv, "pos": pos + 1}

    if pad_h:
        out = out[:, :, :h]
    out = seq_whole(out.reshape(B, S, h * hd) @ params["wo"].to(dtype))
    return out, new_cache


def init_cache(config: ModelConfig, batch: int, max_len: int,
               device: torch.device, dtype: torch.dtype | None = None,
               window: int = 0) -> dict:
    """One layer's cache: 'k', 'v' (batch, Smax, KH, hd) zeros and 'pos'
    0, where Smax is ``min(window, max_len)`` with a window, else
    ``max_len``."""
    size = min(window, max_len) if window > 0 else max_len
    shape = (batch, size, config.num_kv_heads, config.resolved_head_dim)
    dtype = dtype or config.activation_dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}
