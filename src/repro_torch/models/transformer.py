"""Decoder-only transformer LM, the dense and MoE families: init and the
serve path.

The counterpart of ``repro/models/transformer.py`` for ``family="dense"``
and ``"moe"``: a block with ``num_experts > 0`` has an MoE layer
(``models/moe.py``) where a dense block has its MLP.
The reference scans a stacked (L, ...) parameter tree under ``jax.lax.scan``
with a remat policy, both compile devices for XLA; here the layers are a
Python list of per-layer dicts, run in a loop. The serve path keeps the
reference's API: ``prefill`` runs the prompt, fills the cache and returns
last-token logits; ``decode_step`` appends one token. The cache keeps the
reference's (L, B, Smax, KH, hd) layout and its scalar ``pos`` (an int
here), and is updated in place. The layers sum the MoE aux loss as the
reference's do; the serve path drops it, and the training loss that reads
it waits for ROADMAP Queue 1 item 8, the VLM image prefix for item 6.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib


# -- init ----------------------------------------------------------------------
def _init_block(gen: torch.Generator, config: ModelConfig,
                dtype: torch.dtype) -> dict:
    params = {"attn": attn.init_attention(gen, config, dtype)}
    if config.num_experts > 0:
        params["moe"] = moe_lib.init_moe(gen, config, dtype)
    else:
        params["mlp"] = L.init_mlp(gen, config, dtype)
    params["norm1"] = L.init_norm(config, dtype, gen.device)
    params["norm2"] = L.init_norm(config, dtype, gen.device)
    return params


def init(gen: torch.Generator, config: ModelConfig) -> dict:
    """Random parameters in ``config.param_dtype``, drawn from ``gen`` on
    its device: {'embed': {...}, 'layers': [per-layer dicts],
    'final_norm': {...}}, the trees the reference's ``init`` builds: no
    ``lm_head`` when the embeddings are tied, no ``w_gate`` in an ungated
    MLP, a ``bias`` beside each LayerNorm's ``scale``, ``moe`` in place of
    ``mlp`` when the config has experts."""
    dtype = config.parameter_dtype
    embed = L.init_embedding(gen, config, dtype)
    layers = [_init_block(gen, config, dtype)
              for _ in range(config.num_layers)]
    return {"embed": embed, "layers": layers,
            "final_norm": L.init_norm(config, dtype, gen.device)}


# The reference's dense path sizes its cache by ``local_window``
# (``transformer.py:256-257``) but calls ``attention_layer`` without one
# (``:104-105``), so a decode past the window writes the cache's last slot
# over and over while the attention sees no window; no reference config
# sets a window on this path, so nothing defines what it should compute
# (ROADMAP Queue 3).
DENSE_WINDOW_REFUSED = (
    "local_window > 0 on the dense/MoE transformer is refused: the "
    "reference sizes this path's cache by the window but attends without "
    "one, so no reference config defines what it computes; the sliding "
    "window is served by the hybrid family (models/rglru.py)")


# -- one transformer block -------------------------------------------------------
def _block(x: torch.Tensor, block_params: dict, config: ModelConfig,
           positions: torch.Tensor, cache: dict | None
           ) -> tuple[torch.Tensor, torch.Tensor | None, dict | None]:
    """One block: (x, the MoE layer's aux loss or None for a dense block,
    the cache)."""
    h = L.apply_norm(x, block_params["norm1"], config)
    a, new_cache = attn.attention_layer(h, block_params["attn"], config,
                                        positions, cache=cache)
    x = x + a
    h = L.apply_norm(x, block_params["norm2"], config)
    if config.num_experts > 0:
        m, aux = moe_lib.moe_layer(h, block_params["moe"], config)
    else:
        m, aux = L.mlp(h, block_params["mlp"], config), None
    return x + m, aux, new_cache


def _run_layers(x: torch.Tensor, params: dict, config: ModelConfig,
                positions: torch.Tensor, cache: dict | None
                ) -> tuple[torch.Tensor, torch.Tensor, dict | None]:
    """The blocks in order, each with its layer's slice of the cache;
    returns (x, the aux losses summed in layer order from an fp32 zero, the
    cache). A dense block adds nothing, where the reference adds a zero."""
    if config.local_window > 0:
        raise NotImplementedError(DENSE_WINDOW_REFUSED)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, block_params in enumerate(params["layers"]):
        layer_cache = None
        if cache is not None:
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i],
                           "pos": cache["pos"]}
        x, aux_i, _ = _block(x, block_params, config, positions,
                             layer_cache)
        if aux_i is not None:
            aux = aux + aux_i
    if cache is None:
        return x, aux, None
    return x, aux, {"k": cache["k"], "v": cache["v"],
                    "pos": cache["pos"] + positions.shape[1]}


# -- input embedding -------------------------------------------------------------
def _embed_inputs(params: dict, tokens: torch.Tensor, config: ModelConfig,
                  start_pos: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    B, S = tokens.shape
    x = L.embed_tokens(tokens, params["embed"], config)
    positions = start_pos + torch.arange(S, device=tokens.device).expand(B, S)
    return x, positions


# -- serving -----------------------------------------------------------------------
def init_cache(config: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    """'k', 'v': (L, batch, max_len, KH, hd) zeros in the activation dtype;
    'pos': 0."""
    layer = attn.init_cache(config, batch, max_len, device)
    shape = (config.num_layers,) + tuple(layer["k"].shape)
    return {"k": layer["k"].new_zeros(shape),
            "v": layer["v"].new_zeros(shape), "pos": 0}


def prefill(params: dict, batch: dict, config: ModelConfig,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Run the full prompt ``batch['tokens']`` (B, S), fill a fresh cache
    of ``max_len`` (default S) slots, return last-token logits (B, 1, V)."""
    tokens = batch["tokens"]
    x, positions = _embed_inputs(params, tokens, config)
    cache = init_cache(config, tokens.shape[0], max_len or x.shape[1],
                       tokens.device)
    x, _, cache = _run_layers(x, params, config, positions, cache)
    x = L.apply_norm(x, params["final_norm"], config)
    return L.lm_logits(x[:, -1:], params["embed"], config), cache


def decode_step(params: dict, tokens: torch.Tensor, cache: dict,
                config: ModelConfig) -> tuple[torch.Tensor, dict]:
    """tokens: (B, 1) -> (logits (B, 1, V), the cache one token on)."""
    x, positions = _embed_inputs(params, tokens, config,
                                 start_pos=cache["pos"])
    x, _, cache = _run_layers(x, params, config, positions, cache)
    x = L.apply_norm(x, params["final_norm"], config)
    return L.lm_logits(x, params["embed"], config), cache
