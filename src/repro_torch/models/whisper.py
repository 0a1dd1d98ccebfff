"""Whisper-style encoder-decoder, the audio family: init, the serve path
and the training loss.

The counterpart of ``repro/models/whisper.py``. The conv frontend is a
stub, as in the reference: a request carries precomputed frame embeddings
(B, encoder_seq, d_model), and the transformer backbone (24 encoder and 24
decoder layers for medium) is what runs. Pre-LN everywhere (LayerNorm),
ungated GELU MLPs, MHA, learned positions added to the encoder's frames
(``enc_pos``) and to the decoder's tokens (``embed.pos``), no RoPE. A
decoder layer has causal self-attention with a KV cache, then
cross-attention over the encoder's output, whose keys and values are
projected once at prefill and reused by every decode step.

Which attention runs where follows the reference's dispatch
(``models/attention.py:attention_core``; its Pallas kernel for a causal,
window-free call with Sq > 1 only): the encoder's non-causal
self-attention over 1,500 frames, past ``attention_block_q``, runs the
``blocked`` schedule; a cross-attention (384 queries for medium's served
prompts) and every decode step take the naive version; and only the
decoder's causal self-attention prefill launches the flash kernel, at hd
64 for medium.

The reference scans stacked (L, ...) parameter trees; here ``encoder`` and
``decoder`` are lists of per-layer dicts run in Python loops, as the
port's transformer runs its layers. The cache keeps the reference's
``self_k``, ``self_v`` (L, B, max_len, KH, hd), ``cross_k``, ``cross_v``
(L, B, encoder_seq, KH, hd) and ``pos`` (an int here), and is updated in
place. ``loss_and_metrics`` is the training loss: the frames through the
encoder, the tokens through the decoder without a cache, each layer of
both under activation checkpointing when ``remat`` is not ``"none"``, as
the reference checkpoints its scan bodies. ``param_specs`` and
``cache_specs`` give the trees' logical axes, and the residual stream is
constrained where the reference's is (``parallel/sharding.py``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.parallel.sharding import (like, logical_constraint,
                                           zeros_logical)


# -- init ------------------------------------------------------------------------
def _init_enc_block(gen: torch.Generator, config: ModelConfig,
                    dtype: torch.dtype) -> dict:
    return {"attn": attn.init_attention(gen, config, dtype),
            "mlp": L.init_mlp(gen, config, dtype),
            "norm1": L.init_norm(config, dtype, gen.device),
            "norm2": L.init_norm(config, dtype, gen.device)}


def _init_dec_block(gen: torch.Generator, config: ModelConfig,
                    dtype: torch.dtype) -> dict:
    return {"self_attn": attn.init_attention(gen, config, dtype),
            "cross_attn": attn.init_attention(gen, config, dtype),
            "mlp": L.init_mlp(gen, config, dtype),
            "norm1": L.init_norm(config, dtype, gen.device),
            "norm2": L.init_norm(config, dtype, gen.device),
            "norm3": L.init_norm(config, dtype, gen.device)}


def init(gen: torch.Generator, config: ModelConfig) -> dict:
    """Random parameters in ``config.param_dtype`` drawn from ``gen`` on its
    device, the reference's tree with the layers as lists: {'embed': {'tok',
    'pos'}, 'enc_pos': (encoder_seq, D), 'encoder': [encoder_layers
    dicts], 'enc_norm', 'decoder': [num_layers dicts], 'dec_norm'}."""
    dtype = config.parameter_dtype
    embed = L.init_embedding(gen, config, dtype)
    encoder = [_init_enc_block(gen, config, dtype)
               for _ in range(config.encoder_layers)]
    decoder = [_init_dec_block(gen, config, dtype)
               for _ in range(config.num_layers)]
    enc_pos = L.normal_init(gen, (config.encoder_seq, config.d_model), 0.02,
                            dtype)
    return {"embed": embed, "enc_pos": enc_pos,
            "encoder": encoder,
            "enc_norm": L.init_norm(config, dtype, gen.device),
            "decoder": decoder,
            "dec_norm": L.init_norm(config, dtype, gen.device)}


def param_specs(config: ModelConfig) -> dict:
    """Logical axes of ``init``'s tree (``repro/models/whisper.py:70``),
    each layer's without the reference's leading "layers" axis."""
    norm_s = L.norm_specs(config)
    enc = {"attn": attn.attention_specs(), "mlp": L.mlp_specs(config),
           "norm1": dict(norm_s), "norm2": dict(norm_s)}
    dec = {"self_attn": attn.attention_specs(),
           "cross_attn": attn.attention_specs(), "mlp": L.mlp_specs(config),
           "norm1": dict(norm_s), "norm2": dict(norm_s),
           "norm3": dict(norm_s)}
    return {"embed": L.embedding_specs(config),
            "enc_pos": ("frames", "embed_fsdp"),
            "encoder": [dict(enc) for _ in range(config.encoder_layers)],
            "enc_norm": dict(norm_s),
            "decoder": [dict(dec) for _ in range(config.num_layers)],
            "dec_norm": dict(norm_s)}


# -- encoder -----------------------------------------------------------------------
def encode(params: dict, frames: torch.Tensor,
           config: ModelConfig) -> torch.Tensor:
    """frames (B, T, D), any float dtype -> the encoder's output (B, T, D)
    in the activation dtype: the frames cast, plus ``enc_pos``, through the
    pre-LN blocks (non-causal self-attention, MLP), then ``enc_norm``."""
    x = frames.to(config.activation_dtype)
    B, T, _ = x.shape
    x = x + params["enc_pos"].to(x.dtype)[None, :T]
    positions = torch.arange(T, device=x.device).expand(B, T)
    x = logical_constraint(x, "batch", "act_seq", "embed")

    def block(x: torch.Tensor, p: dict) -> torch.Tensor:
        h = L.apply_norm(x, p["norm1"], config)
        a, _ = attn.attention_layer(h, p["attn"], config, positions,
                                    causal=False)
        x = x + a
        h = L.apply_norm(x, p["norm2"], config)
        return logical_constraint(x + L.mlp(h, p["mlp"], config), "batch",
                                  "act_seq", "embed")

    block = L.remat(block, L.layer_policy(config))
    for p in params["encoder"]:
        x = block(x, p)
    return L.apply_norm(x, params["enc_norm"], config)


# -- decoder -----------------------------------------------------------------------
def _dec_layer(x: torch.Tensor, p: dict, config: ModelConfig,
               positions: torch.Tensor, enc_out: torch.Tensor | None,
               layer_cache: dict | None) -> torch.Tensor:
    """One decoder block: self-attention, cross-attention, MLP, each after
    its norm. With ``layer_cache`` (the layer's 'self_k', 'self_v',
    'cross_k', 'cross_v' and 'pos') the self-attention is cached and the
    cross K/V are projected from ``enc_out`` and written to the cache at
    prefill, or read from it when ``enc_out`` is None; without one
    (training) the block attends over ``x`` itself and projects the cross
    K/V from ``enc_out``."""
    self_cache = None if layer_cache is None else {
        "k": layer_cache["self_k"], "v": layer_cache["self_v"],
        "pos": layer_cache["pos"]}
    h = L.apply_norm(x, p["norm1"], config)
    a, _ = attn.attention_layer(h, p["self_attn"], config, positions,
                                cache=self_cache)
    x = x + a
    h = L.apply_norm(x, p["norm2"], config)
    if enc_out is not None:         # project the encoder's K/V
        c, cross = attn.attention_layer(h, p["cross_attn"], config,
                                        positions, kv_source=enc_out)
        if layer_cache is not None:
            for name in ("k", "v"):
                ref = layer_cache["cross_" + name]
                ref.copy_(like(cross[name], ref))
    else:                           # decode: reuse the cached K/V
        c, _ = attn.attention_layer(
            h, p["cross_attn"], config, positions,
            precomputed_kv=(layer_cache["cross_k"], layer_cache["cross_v"]))
    x = x + c
    h = L.apply_norm(x, p["norm3"], config)
    return logical_constraint(x + L.mlp(h, p["mlp"], config), "batch",
                              "act_seq", "embed")


def _decode_layers(params: dict, x: torch.Tensor, config: ModelConfig,
                   positions: torch.Tensor, enc_out: torch.Tensor | None,
                   cache: dict | None) -> tuple[torch.Tensor, dict | None]:
    """The decoder blocks over ``x``, each with its layer's slice of the
    cache; returns (x, the cache with ``pos`` advanced). Without a cache
    (training) each block runs under the config's remat policy, and the
    cache returned is None."""
    if cache is None:
        def layer(x: torch.Tensor, p: dict) -> torch.Tensor:
            return _dec_layer(x, p, config, positions, enc_out, None)

        layer = L.remat(layer, L.layer_policy(config))
        for p in params["decoder"]:
            x = layer(x, p)
        return x, None
    pos = cache["pos"]
    for i, p in enumerate(params["decoder"]):
        x = _dec_layer(x, p, config, positions, enc_out,
                       {"self_k": cache["self_k"][i],
                        "self_v": cache["self_v"][i],
                        "cross_k": cache["cross_k"][i],
                        "cross_v": cache["cross_v"][i], "pos": pos})
    return x, {**cache, "pos": pos + positions.shape[1]}


def _embed_dec(params: dict, tokens: torch.Tensor, config: ModelConfig,
               start_pos: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Token embeddings plus the learned positions ``embed.pos`` at
    ``start_pos`` on; returns (x, positions)."""
    B, S = tokens.shape
    x = L.embed_tokens(tokens, params["embed"], config)
    positions = start_pos + torch.arange(S, device=tokens.device).expand(B, S)
    x = x + L.lookup(params["embed"]["pos"].to(x.dtype), positions)
    return logical_constraint(x, "batch", "act_seq", "embed"), positions


# -- serving -----------------------------------------------------------------------
def init_cache(config: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    """'self_k', 'self_v': (L, batch, max_len, KH, hd); 'cross_k',
    'cross_v': (L, batch, encoder_seq, KH, hd); zeros in the activation
    dtype; 'pos': 0."""
    kh, hd = config.num_kv_heads, config.resolved_head_dim
    n, T = config.num_layers, config.encoder_seq

    def zeros(length: int) -> torch.Tensor:
        return torch.zeros((n, batch, length, kh, hd),
                           dtype=config.activation_dtype, device=device)

    return {"self_k": zeros(max_len), "self_v": zeros(max_len),
            "cross_k": zeros(T), "cross_v": zeros(T), "pos": 0}


def cache_specs(config: ModelConfig) -> dict:
    """Logical axes of ``init_cache``'s tree, stacked on L as the
    reference's (``repro/models/whisper.py:206``)."""
    kv = ("layers", "batch", "null", "kv_heads", "head_dim")
    return {"self_k": kv, "self_v": kv, "cross_k": kv, "cross_v": kv,
            "pos": ()}


def prefill(params: dict, batch: dict, config: ModelConfig,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Encode ``batch['frames']`` (B, encoder_seq, D), run the prompt
    ``batch['tokens']`` (B, S) through the decoder, fill a fresh cache of
    ``max_len`` (default S) self-attention slots and the cross K/V, return
    last-token logits (B, 1, V)."""
    tokens = batch["tokens"]
    enc_out = encode(params, batch["frames"], config)
    cache = zeros_logical(lambda dev: init_cache(
        config, tokens.shape[0], max_len or tokens.shape[1], dev),
        cache_specs(config), tokens.device)
    x, positions = _embed_dec(params, tokens, config, 0)
    x, cache = _decode_layers(params, x, config, positions, enc_out, cache)
    x = L.apply_norm(x, params["dec_norm"], config)
    return L.lm_logits(x[:, -1:], params["embed"], config), cache


def decode_step(params: dict, tokens: torch.Tensor, cache: dict,
                config: ModelConfig) -> tuple[torch.Tensor, dict]:
    """tokens: (B, 1) -> (logits (B, 1, V), the cache one token on)."""
    x, positions = _embed_dec(params, tokens, config, cache["pos"])
    x, cache = _decode_layers(params, x, config, positions, None, cache)
    x = L.apply_norm(x, params["dec_norm"], config)
    return L.lm_logits(x, params["embed"], config), cache


def loss_and_metrics(params: dict, batch: dict, config: ModelConfig
                     ) -> tuple[torch.Tensor, dict]:
    """The training loss: ``batch['frames']`` through the encoder, the
    next-token cross-entropy of ``batch['tokens']`` through the decoder
    over it (``transformer._chunked_ce``); the aux loss an fp32 zero."""
    enc_out = encode(params, batch["frames"], config)
    x, positions = _embed_dec(params, batch["tokens"], config, 0)
    x, _ = _decode_layers(params, x, config, positions, enc_out, None)
    x = L.apply_norm(x, params["dec_norm"], config)
    pred, targets, mask = transformer.next_token_targets(x, batch)
    loss = transformer._chunked_ce(pred, params, config, targets, mask)
    return loss, {"loss": loss,
                  "aux_loss": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}
