"""RecurrentGemma: RG-LRU recurrent blocks and local sliding-window
attention, init and the serve path.

The counterpart of ``repro/models/rglru.py``. The layer pattern cycles
``config.block_pattern``, ``(rec, rec, attn)`` for recurrentgemma-2b: two
gated-linear-recurrence blocks per local-attention block, each followed by
a GeGLU MLP. The RG-LRU recurrence, in fp32,

    r_t = σ(W_a x_t + b_a)          (recurrence gate)
    i_t = σ(W_x x_t + b_x)          (input gate)
    a_t = exp(-c · softplus(Λ) · r_t)           (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

is a diagonal linear recurrence. A prefill evaluates it as a log-depth
doubling scan over time in PyTorch operations (ceil(log2 T) rounds of the
reference's combine, where the reference runs ``jax.lax.associative_scan``),
never a loop over tokens; a decode step is one update. The reference
has no Pallas kernel for it, and the port writes none. The decode state is
constant-size: the LRU state ``h`` (fp32), the conv's last ``conv_width -
1`` inputs (activation dtype) and a ``local_window`` rolling KV buffer.

The attention blocks take the window, so no flash kernel runs in this
family (the reference takes its kernel at window 0 only): a prefill past
``attention_block_q`` (recurrentgemma-2b's 2,560-token prompts) runs the
``blocked`` schedule, as the reference's does, and a decode step the
naive attention. Params and caches are per-layer dicts keyed
``layer_NN``, as the reference's, not stacked on L. ``loss_and_metrics``
is the training loss, each layer under activation checkpointing when
``remat`` is not ``"none"``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.parallel.sharding import logical_constraint, zeros_logical

_C = 8.0  # RG-LRU sharpness constant


def layer_kinds(config: ModelConfig) -> list[str]:
    pat = config.block_pattern
    return [pat[i % len(pat)] for i in range(config.num_layers)]


def _key(i: int) -> str:
    return f"layer_{i:02d}"


# -- init ------------------------------------------------------------------------
def _init_rec_block(gen: torch.Generator, config: ModelConfig,
                    dtype: torch.dtype) -> dict:
    """The reference's recurrent block: its standard deviations, zero conv
    and gate biases (the gate biases fp32), and Λ = linspace(0.3, 1.5) in
    fp32."""
    d, w = config.d_model, config.lru_width or config.d_model
    dev = gen.device
    std, stdw = 1.0 / math.sqrt(d), 1.0 / math.sqrt(w)
    return {
        "w_in_x": L.normal_init(gen, (d, w), std, dtype),
        "w_in_gate": L.normal_init(gen, (d, w), std, dtype),
        "conv_w": L.normal_init(gen, (config.conv_width, w), stdw, dtype),
        "conv_b": torch.zeros(w, dtype=dtype, device=dev),
        "wa": L.normal_init(gen, (w, w), stdw, dtype),
        "ba": torch.zeros(w, dtype=torch.float32, device=dev),
        "wx": L.normal_init(gen, (w, w), stdw, dtype),
        "bx": torch.zeros(w, dtype=torch.float32, device=dev),
        "lam": torch.from_numpy(
            np.linspace(0.3, 1.5, w).astype(np.float32)).to(dev),
        "w_out": L.normal_init(
            gen, (w, d), stdw / math.sqrt(2.0 * config.num_layers), dtype),
    }


def init(gen: torch.Generator, config: ModelConfig) -> dict:
    """Random parameters in ``config.param_dtype`` drawn from ``gen`` on
    its device: {'embed': {...}, 'layer_00': {'rec' or 'attn', 'mlp',
    'norm1', 'norm2'}, ..., 'final_norm': {...}}, the reference's tree."""
    dtype = config.parameter_dtype
    params: dict = {"embed": L.init_embedding(gen, config, dtype)}
    for i, kind in enumerate(layer_kinds(config)):
        blk: dict = {}
        if kind == "rec":
            blk["rec"] = _init_rec_block(gen, config, dtype)
        else:
            blk["attn"] = attn.init_attention(gen, config, dtype)
        blk["mlp"] = L.init_mlp(gen, config, dtype)
        blk["norm1"] = L.init_norm(config, dtype, gen.device)
        blk["norm2"] = L.init_norm(config, dtype, gen.device)
        params[_key(i)] = blk
    params["final_norm"] = L.init_norm(config, dtype, gen.device)
    return params


_REC_SPECS = {
    "w_in_x": ("embed_fsdp", "lru"), "w_in_gate": ("embed_fsdp", "lru"),
    "conv_w": ("conv", "lru"), "conv_b": ("lru",),
    "wa": ("null", "lru"), "ba": ("lru",),
    "wx": ("null", "lru"), "bx": ("lru",),
    "lam": ("lru",), "w_out": ("lru", "embed_fsdp"),
}


def param_specs(config: ModelConfig) -> dict:
    """Logical axes of ``init``'s tree (``repro/models/rglru.py:95``);
    the reference's attention blocks leave out a gated MLP's switch."""
    mlp_s = {"w_up": ("embed_fsdp", "ff"), "w_down": ("ff", "embed_fsdp"),
             "w_gate": ("embed_fsdp", "ff")}
    specs: dict = {"embed": L.embedding_specs(config)}
    for i, kind in enumerate(layer_kinds(config)):
        blk: dict = {"rec": dict(_REC_SPECS)} if kind == "rec" else \
            {"attn": attn.attention_specs()}
        blk.update(mlp=dict(mlp_s), norm1=L.norm_specs(config),
                   norm2=L.norm_specs(config))
        specs[_key(i)] = blk
    specs["final_norm"] = L.norm_specs(config)
    return specs


# -- RG-LRU core -------------------------------------------------------------------
def _gates(x32: torch.Tensor, p: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(log a_t, i_t ⊙ x_t) in fp32."""
    r = torch.sigmoid(x32 @ p["wa"].float() + p["ba"])
    i = torch.sigmoid(x32 @ p["wx"].float() + p["bx"])
    log_a = -_C * F.softplus(p["lam"]) * r                    # ≤ 0
    return log_a, i * x32


def _rg_lru(x: torch.Tensor, p: dict, h0: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, W) -> (y in x's dtype, h_last fp32). h_t = a_t h_{t-1} +
    b_t, seeded with h0 folded into b_1, by a doubling scan: after the
    round at offset o, (a_t, b_t) composes steps t - 2o + 1 .. t."""
    log_a, gated = _gates(x.float(), p)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)
                   ) * gated
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    T, off = x.shape[1], 1
    while off < T:
        # combine((a1, b1), (a2, b2)) = (a1 a2, a2 b1 + b2), the earlier
        # segment on the left
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return b.to(x.dtype), b[:, -1]


def _rg_lru_step(x: torch.Tensor, p: dict, h0: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One token: x (B, W) -> (y in x's dtype, h fp32)."""
    log_a, gated = _gates(x.float(), p)
    a = torch.exp(log_a)
    h = a * h0 + torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated
    return h.to(x.dtype), h


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv in x's dtype; x: (B, T, W), w: (cw, W), tail:
    (B, cw - 1, W), the inputs before x. Returns (y, the new tail)."""
    cw, T = w.shape[0], x.shape[1]
    xt = torch.cat([tail.to(x.dtype), x], dim=1)
    y = sum(xt[:, i:i + T] * w[i].to(x.dtype) for i in range(cw))
    return y + b.to(x.dtype), xt[:, xt.shape[1] - (cw - 1):]


def _rec_block(x: torch.Tensor, p: dict, state: dict
               ) -> tuple[torch.Tensor, dict]:
    """The recurrent block: a GELU gate, the input projection through the
    causal conv and the RG-LRU, gated, projected out. ``state``: 'h' (B,
    W) fp32 and 'conv' (B, cw - 1, W)."""
    dtype = x.dtype
    x = L.seq_whole(x)
    gate = L.activation(x @ p["w_in_gate"].to(dtype), "gelu")
    # the conv and the scan run along the whole sequence
    h = logical_constraint(x @ p["w_in_x"].to(dtype), "batch", "seq", "lru")
    h, conv_tail = _causal_conv(h, p["conv_w"], p["conv_b"], state["conv"])
    if x.shape[1] == 1:
        y, h_last = _rg_lru_step(h[:, 0], p, state["h"])
        y = y[:, None]
    else:
        y, h_last = _rg_lru(h, p, state["h"])
    out = L.seq_whole((y * gate) @ p["w_out"].to(dtype))
    return out, {"h": h_last.float(), "conv": conv_tail}


# -- model ---------------------------------------------------------------------------
def _layer(x: torch.Tensor, p: dict, kind: str, config: ModelConfig,
           positions: torch.Tensor, layer_cache: dict | None,
           pos: int) -> tuple[torch.Tensor, dict | None]:
    """One layer, a recurrent or an attention block and the MLP, each
    after its norm; ``layer_cache`` None starts a recurrent block from a
    zero state and runs attention without a cache. Returns (x, the layer's
    new cache, or None without one)."""
    B = x.shape[0]
    w_lru = config.lru_width or config.d_model
    h = L.apply_norm(x, p["norm1"], config)
    if kind == "rec":
        state = layer_cache
        if state is None:
            state = {"h": torch.zeros((B, w_lru), dtype=torch.float32,
                                      device=x.device),
                     "conv": x.new_zeros((B, config.conv_width - 1, w_lru))}
        a, nc = _rec_block(h, p["rec"], state)
    else:
        lc = None if layer_cache is None else {**layer_cache, "pos": pos}
        a, nc = attn.attention_layer(h, p["attn"], config, positions,
                                     cache=lc, window=config.local_window)
        if nc is not None:
            nc = {"k": nc["k"], "v": nc["v"]}
    x = x + a
    h = L.apply_norm(x, p["norm2"], config)
    x = logical_constraint(x + L.mlp(h, p["mlp"], config), "batch",
                           "act_seq", "embed")
    return x, None if layer_cache is None else nc


def _forward(params: dict, tokens: torch.Tensor, config: ModelConfig,
             cache: dict | None, start_pos: int
             ) -> tuple[torch.Tensor, dict | None]:
    """The final-normed hidden states (B, S, D), and with ``cache`` the
    cache ``S`` tokens on. Without a cache each layer runs under the
    config's ``remat`` policy while autograd records, as the reference
    checkpoints each layer when ``remat`` is not ``"none"``."""
    B, S = tokens.shape
    x = L.embed_tokens(tokens, params["embed"], config)
    positions = start_pos + torch.arange(S, device=tokens.device).expand(B, S)
    x = logical_constraint(x, "batch", "act_seq", "embed")
    if cache is None:
        for i, kind in enumerate(layer_kinds(config)):
            def layer(x: torch.Tensor, p: dict, kind: str = kind
                      ) -> torch.Tensor:
                return _layer(x, p, kind, config, positions, None, 0)[0]

            x = L.remat(layer, L.layer_policy(config))(x, params[_key(i)])
        return L.apply_norm(x, params["final_norm"], config), None
    new_cache = {"pos": cache["pos"] + S}
    for i, kind in enumerate(layer_kinds(config)):
        x, new_cache[_key(i)] = _layer(x, params[_key(i)], kind, config,
                                       positions, cache[_key(i)],
                                       cache["pos"])
    return L.apply_norm(x, params["final_norm"], config), new_cache


def init_cache(config: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    """'pos' 0 and per layer: a recurrent block's 'h' (batch, W) fp32 and
    'conv' (batch, cw - 1, W), an attention block's 'k', 'v' (batch,
    min(window, max_len), KH, hd), zeros in the activation dtype."""
    w_lru = config.lru_width or config.d_model
    dtype = config.activation_dtype
    cache: dict = {"pos": 0}
    for i, kind in enumerate(layer_kinds(config)):
        if kind == "rec":
            cache[_key(i)] = {
                "h": torch.zeros((batch, w_lru), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((batch, config.conv_width - 1, w_lru),
                                    dtype=dtype, device=device)}
        else:
            layer = attn.init_cache(config, batch, max_len, device,
                                    window=config.local_window)
            cache[_key(i)] = {"k": layer["k"], "v": layer["v"]}
    return cache


def cache_specs(config: ModelConfig) -> dict:
    """Logical axes of ``init_cache``'s tree (``repro/models/rglru.py:248``)."""
    specs: dict = {"pos": ()}
    for i, kind in enumerate(layer_kinds(config)):
        if kind == "rec":
            specs[_key(i)] = {"h": ("batch", "lru"),
                              "conv": ("batch", "conv", "lru")}
        else:
            kv = ("batch", "null", "kv_heads", "head_dim")
            specs[_key(i)] = {"k": kv, "v": kv}
    return specs


def prefill(params: dict, batch: dict, config: ModelConfig,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Run the prompt ``batch['tokens']`` (B, S), fill a fresh cache for
    ``max_len`` (default S) tokens, return last-token logits (B, 1, V)."""
    tokens = batch["tokens"]
    cache = zeros_logical(lambda dev: init_cache(
        config, tokens.shape[0], max_len or tokens.shape[1], dev),
        cache_specs(config), tokens.device)
    x, cache = _forward(params, tokens, config, cache, 0)
    return L.lm_logits(x[:, -1:], params["embed"], config), cache


def decode_step(params: dict, tokens: torch.Tensor, cache: dict,
                config: ModelConfig) -> tuple[torch.Tensor, dict]:
    """tokens: (B, 1) -> (logits (B, 1, V), the cache one token on)."""
    x, cache = _forward(params, tokens, config, cache, cache["pos"])
    return L.lm_logits(x, params["embed"], config), cache


def loss_and_metrics(params: dict, batch: dict, config: ModelConfig
                     ) -> tuple[torch.Tensor, dict]:
    """The training loss: the next-token cross-entropy of the tokens from
    a zero state (``transformer._chunked_ce``); the aux loss an fp32 zero."""
    x, _ = _forward(params, batch["tokens"], config, None, 0)
    pred, targets, mask = transformer.next_token_targets(x, batch)
    loss = transformer._chunked_ce(pred, params, config, targets, mask)
    return loss, {"loss": loss,
                  "aux_loss": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}
