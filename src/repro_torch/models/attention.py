"""Attention: GQA/MQA/MHA with RoPE, causal self-attention (with or without
a sliding window), non-causal self-attention and cross-attention
(whisper), and the serve path's KV cache.

The counterpart of ``repro/models/attention.py``, trimmed to the serve
path. Two implementations of the same function:

* ``naive`` — the full score matrix in fp32; the oracle, and what every
              call that is not a causal, window-free prefill takes (decode,
              Sq = 1, every windowed call, whisper's non-causal encoder
              self-attention and every cross-attention).
* ``flash`` — the CUDA flash kernel (``kernels/flash_attention``), taken
              for causal, window-free attention with Sq > 1 on the card,
              where the reference would take its Pallas kernel under
              ``attention_impl='pallas'`` (``attention.py:258``, which also
              asks for window 0); every other call takes the naive version.

``attention_impl`` is ``"flash"`` (the default) or ``"naive"`` (naive
everywhere, so one model runs with and without the kernel). The
reference's ``blocked`` and ``triangular`` schedules compute the naive
function in tiles for XLA (ROADMAP Queue 1 item 7); a config that asks
for one is refused, naming its item, rather than served otherwise. Where
the reference would tile a long non-causal call (whisper's 1,500-frame
encoder) as ``blocked``, the port computes the same function untiled. The
reference's head padding (``pad_attention_heads``) pads H to a mesh's
tensor-parallel degree and pads 0 heads without one
(``attention.py:317-320``); it comes with the port's mesh (ROADMAP Queue 1
item 9).

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

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import apply_rope, normal_init

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


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
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


# -- dispatch --------------------------------------------------------------------
def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   qpos: torch.Tensor, kpos: torch.Tensor,
                   config: ModelConfig, causal: bool = True,
                   window: int = 0) -> torch.Tensor:
    impl = config.attention_impl
    if impl not in ("flash", "naive"):
        raise NotImplementedError(f"attention_impl={impl!r} waits for "
                                  f"ROADMAP Queue 1 item 7")
    if (impl == "flash" and causal and window == 0 and q.shape[1] > 1
            and q.is_cuda):
        # like the reference's Pallas call, qpos/kpos are not read: the
        # causal prefill's positions are 0..S-1 on both sides
        return fa_ops.flash_attention(q, k, v)
    return naive_attention(q, k, v, qpos, kpos, causal, window)


def attention_layer(x: torch.Tensor, params: dict, config: ModelConfig,
                    positions: torch.Tensor, cache: dict | None = None,
                    kv_source: torch.Tensor | None = None,
                    precomputed_kv: tuple[torch.Tensor, torch.Tensor]
                    | None = None,
                    causal: bool = True, window: int = 0
                    ) -> tuple[torch.Tensor, dict | None]:
    """Attention layer: qkv projections, RoPE, core, out projection.

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

    q = _split_heads(x @ params["wq"].to(dtype), h, hd)
    if precomputed_kv is not None:
        k, v = precomputed_kv
    else:
        src = x if kv_source is None else kv_source
        k = _split_heads(src @ params["wk"].to(dtype), kh, hd)
        v = _split_heads(src @ params["wv"].to(dtype), kh, hd)
    cross = kv_source is not None or precomputed_kv is not None
    if config.pos_embedding == "rope" and not cross:
        q = apply_rope(q, positions, config.rope_theta)
        k = apply_rope(k, positions, config.rope_theta)

    def rep(t: torch.Tensor) -> torch.Tensor:
        # repeat KV to the full H heads (the reference's 4-D layout)
        return torch.repeat_interleave(t, g, dim=2) if g > 1 else t

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
            ck.copy_(torch.roll(k[:, S - Smax:], shift, dims=1))
            cv.copy_(torch.roll(v[:, S - Smax:], shift, dims=1))
        else:
            n = min(S, Smax)
            start = min(max(pos, 0), Smax - n)  # dynamic_update_slice's clamp
            ck[:, start:start + n] = k[:, :n].to(ck.dtype)
            cv[:, start:start + n] = v[:, :n].to(cv.dtype)
        new_cache = {"k": ck, "v": cv, "pos": pos + S}
    else:
        # decode; with a window the buffer wraps in place
        ck, cv, pos = cache["k"], cache["v"], cache["pos"]
        Smax = ck.shape[1]
        slot = pos % Smax if window > 0 else min(pos, Smax - 1)
        ck[:, slot:slot + 1] = k.to(ck.dtype)
        cv[:, slot:slot + 1] = v.to(cv.dtype)
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
        out = attention_core(q, rep(ck), rep(cv), positions, kpos, config,
                             causal=True, window=window)
        new_cache = {"k": ck, "v": cv, "pos": pos + 1}

    out = out.reshape(B, S, h * hd) @ params["wo"].to(dtype)
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
