"""Decoder-only transformer LM, the dense, MoE and VLM families: init,
the serve path and the training loss.

The counterpart of ``repro/models/transformer.py`` for ``family="dense"``,
``"moe"`` and ``"vlm"``: a block with ``num_experts > 0`` has an MoE layer
(``models/moe.py``) where a dense block has its MLP; a VLM batch carries
``image_embeds`` (B, num_image_tokens, D), precomputed patch embeddings
(the anyres frontend is a stub, as in the reference), prepended to the
token embeddings, with positions running over the whole sequence.
The reference scans a stacked (L, ...) parameter tree under ``jax.lax.scan``;
here the layers are a Python list of per-layer dicts, run in a loop, each
block under the config's ``remat`` policy while autograd records
(``layers.remat``). The serve path keeps the reference's API: ``prefill``
runs the prompt (behind its image prefix), fills the cache and returns
last-token logits; ``decode_step`` appends one token. The cache keeps the
reference's (L, B, Smax, KH, hd) layout and its scalar ``pos`` (an int
here), and is updated in place. ``loss_and_metrics`` is the training loss:
the next-token cross-entropy by ``_chunked_ce``, whose (B, S, V) logits
never exist at once, plus the MoE layers' aux loss; a VLM sequence's last
image position predicts its first token, and no image position is a target.
A block whose config sets the ``_moe_impl: "a2a"`` override runs
``moe_layer_a2a`` (the reference's all-to-all expert parallelism) in the
prefill, the decode and the loss alike; one with ``moe_dropless`` runs
``moe_layer_dropless``. A config with an ``attention_pattern`` (the
port's own; mellum2-12b-a2.5b) gives each layer a kind (``layer_kinds``):
a full layer attends causally with the full layers' RoPE (yarn, where
``full_rope`` is set), a sliding one over its last ``local_window`` keys
with default RoPE; its cache keeps a stack of each kind side by side,
the full layers' at ``max_len`` and the sliding layers' as rolling
buffers of ``min(window, max_len)`` slots. A model without a pattern
keeps the single stack.
``param_specs`` and ``cache_specs`` give the trees' logical axes
(``parallel/sharding.py``); the residual stream is constrained where the
reference's is, and under a mesh the loss's chunks take the vocabulary
whole before the target's gather. Each layer, its attention and its MLP
or experts, and each CE chunk run in a ``cost_scope`` of that name, which
the dry-run's walker (``launch/opcost.py``) files their work under and
which, while a profiler records, is a span of the span log
(``data/metrics.py``) and a profiler range.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.metrics import get_registry
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.parallel.sharding import (is_dtensor, local_shard,
                                           logical_constraint, redistribute,
                                           summed, whole, zeros_logical)
from repro_torch.utils import cost_scope


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


def _block_specs(config: ModelConfig) -> dict:
    """One block's logical axes (``repro/models/transformer.py:48``),
    the MoE's with the reference's a2a choice of axes."""
    specs: dict = {"attn": attn.attention_specs()}
    if config.num_experts > 0:
        specs["moe"] = moe_lib.moe_specs(config)
    else:
        specs["mlp"] = L.mlp_specs(config)
    specs["norm1"] = L.norm_specs(config)
    specs["norm2"] = L.norm_specs(config)
    return specs


def param_specs(config: ModelConfig) -> dict:
    """Logical axes of ``init``'s tree (``repro/models/transformer.py:84``):
    each layer's dict takes the reference's stacked spec without its
    leading "layers" axis."""
    return {"embed": L.embedding_specs(config),
            "layers": [_block_specs(config)
                       for _ in range(config.num_layers)],
            "final_norm": L.norm_specs(config)}


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
# (ROADMAP Queue 3). A window comes with an ``attention_pattern`` that
# says which layers slide.
DENSE_WINDOW_REFUSED = (
    "local_window > 0 on the dense/MoE transformer is refused: the "
    "reference sizes this path's cache by the window but attends without "
    "one, so no reference config defines what it computes; the sliding "
    "window is served by the hybrid family (models/rglru.py) or by an "
    "attention_pattern naming the sliding layers")
KINDS = ("full", "sliding")


def layer_kinds(config: ModelConfig) -> list[str]:
    """Each layer's attention kind, ``attention_pattern`` cycled over the
    layers: "full", or "sliding" over ``local_window`` keys. Without a
    pattern every layer is full, and a window is refused."""
    pattern = config.attention_pattern or ("full",)
    if not config.attention_pattern and config.local_window > 0:
        raise NotImplementedError(DENSE_WINDOW_REFUSED)
    if set(pattern) - set(KINDS):
        raise ValueError(f"attention_pattern {pattern}: each of {KINDS}")
    if "sliding" in pattern and config.local_window <= 0:
        raise ValueError("a sliding layer needs local_window > 0")
    return [pattern[i % len(pattern)] for i in range(config.num_layers)]


def _cache_keys(kind: str) -> tuple[str, str]:
    """The cache's stacks of a kind: 'k'/'v' for the full layers, as a
    model with no pattern keeps them, 'k_sliding'/'v_sliding' for the
    rolling buffers of the sliding ones."""
    return ("k", "v") if kind == "full" else ("k_sliding", "v_sliding")


# -- one transformer block -------------------------------------------------------
def _block(x: torch.Tensor, block_params: dict, config: ModelConfig,
           positions: torch.Tensor, cache: dict | None, kind: str = "full"
           ) -> tuple[torch.Tensor, torch.Tensor | None, dict | None]:
    """One block, its attention of ``kind``: (x, the MoE layer's aux loss
    or None for a dense block, the cache). The ``attention`` scope is a
    device span with the kind among its attrs."""
    sliding = kind == "sliding"
    with cost_scope("attention", device=True, attrs={"kind": kind}):
        h = L.apply_norm(x, block_params["norm1"], config)
        a, new_cache = attn.attention_layer(
            h, block_params["attn"], config, positions, cache=cache,
            window=config.local_window if sliding else 0,
            yarn=None if sliding else config.full_rope)
    x = logical_constraint(x + a, "batch", "act_seq", "embed")
    with cost_scope("experts" if config.num_experts > 0 else "mlp"):
        h = L.apply_norm(x, block_params["norm2"], config)
        if config.num_experts > 0:
            if config.sharding_overrides.get("_moe_impl") == "a2a":
                m, aux = moe_lib.moe_layer_a2a(h, block_params["moe"],
                                               config)
            elif config.moe_dropless:
                m, aux = moe_lib.moe_layer_dropless(h, block_params["moe"],
                                                    config)
            else:
                m, aux = moe_lib.moe_layer(h, block_params["moe"], config)
        else:
            m, aux = L.mlp(h, block_params["mlp"], config), None
    x = logical_constraint(x + m, "batch", "act_seq", "embed")
    return x, aux, new_cache


def _run_layers(x: torch.Tensor, params: dict, config: ModelConfig,
                positions: torch.Tensor, cache: dict | None
                ) -> tuple[torch.Tensor, torch.Tensor, dict | None]:
    """The blocks in order, each with its layer's slice of its kind's
    cache stack (or, without a cache, under the config's ``remat``
    policy); returns (x, the aux losses summed in layer order from an
    fp32 zero, the cache). A dense block adds nothing, where the
    reference adds a zero."""
    kinds = layer_kinds(config)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cache is None:
        def block(x: torch.Tensor, block_params: dict, kind: str):
            x, aux_i, _ = _block(x, block_params, config, positions, None,
                                 kind)
            return x, aux_i

        block = L.remat(block, config.remat)
        for i, block_params in enumerate(params["layers"]):
            with cost_scope("layer", i):
                x, aux_i = block(x, block_params, kinds[i])
            if aux_i is not None:
                aux = aux + aux_i
        return x, aux, None
    seen = dict.fromkeys(KINDS, 0)      # layers of each kind so far
    for i, block_params in enumerate(params["layers"]):
        kind = kinds[i]
        ks, vs = _cache_keys(kind)
        layer_cache = {"k": cache[ks][seen[kind]], "v": cache[vs][seen[kind]],
                       "pos": cache["pos"]}
        seen[kind] += 1
        with cost_scope("layer", i):
            x, aux_i, _ = _block(x, block_params, config, positions,
                                 layer_cache, kind)
        if aux_i is not None:
            aux = aux + aux_i
    return x, aux, {**cache, "pos": cache["pos"] + positions.shape[1]}


# -- input embedding -------------------------------------------------------------
def _embed_inputs(params: dict, batch: dict, config: ModelConfig,
                  start_pos: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The token embeddings of ``batch['tokens']``, behind the VLM image
    prefix ``batch['image_embeds']`` cast to the activation dtype when the
    family is ``vlm`` and the batch carries one; positions from
    ``start_pos`` over the whole sequence (the learned table added when
    the config has one). Returns (x, positions)."""
    tokens = batch["tokens"]
    x = L.embed_tokens(tokens, params["embed"], config)
    if config.family == "vlm" and "image_embeds" in batch:
        x = torch.cat([batch["image_embeds"].to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    positions = start_pos + torch.arange(S, device=tokens.device).expand(B, S)
    if config.pos_embedding == "learned":
        x = x + L.lookup(params["embed"]["pos"].to(x.dtype), positions)
    return logical_constraint(x, "batch", "act_seq", "embed"), positions


# -- losses ------------------------------------------------------------------------
def _chunked_ce(x: torch.Tensor, params: dict, config: ModelConfig,
                targets: torch.Tensor, mask: torch.Tensor,
                chunk: int = 128) -> torch.Tensor:
    """The masked token-mean cross-entropy of ``lm_logits(x)`` against
    ``targets`` without the (B, S, V) logits: ``chunk`` positions at a time,
    each chunk's head product and logsumexp under activation checkpointing
    (recomputed in the backward pass), the sums carried in fp32 in chunk
    order as the reference's scan carries them. The reference pads the
    last chunk with masked positions, which add exact zeros; the port cuts
    it short instead (DTensor's pad strategy in torch 2.11 leaves a
    placement a mesh dimension short)."""
    x = L.seq_whole(x)
    n = -(-x.shape[1] // chunk)

    def chunk_nll(xc: torch.Tensor, tc: torch.Tensor, mc: torch.Tensor
                  ) -> torch.Tensor:
        # the vocabulary whole on every rank of the 'model' axis: DTensor
        # has no working strategy for the target's gather on a sharded one
        logits = logical_constraint(
            L.lm_logits(xc, params["embed"], config).float(), "batch",
            "seq", None)
        if is_dtensor(logits):
            return _local_nll(logits, tc, mc)
        logz = torch.logsumexp(logits, dim=-1)
        tl = torch.gather(logits, -1, tc[..., None])[..., 0]
        return torch.sum((logz - tl) * mc.float())

    chunk_nll = L.remat(chunk_nll, "full")
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    mask_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n):
        cols = slice(c * chunk, (c + 1) * chunk)
        with cost_scope("ce", c):
            loss_sum = loss_sum + chunk_nll(x[:, cols], targets[:, cols],
                                            mask[:, cols])
        mask_sum = mask_sum + torch.sum(mask[:, cols].float())
    return loss_sum / torch.clamp(mask_sum, min=1.0)


def _local_nll(logits, targets: torch.Tensor, mask: torch.Tensor):
    """A chunk's masked NLL sum from DTensor logits whose vocabulary is
    whole on every rank: each rank sums its own rows, and the sums are a
    pending sum over the mesh axes that shard the batch (DTensor's gather
    on these logits leaves a masked pending sum that torch 2.11 fails to
    reduce)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, places = logits.device_mesh, summed(logits.placements)
    if any(isinstance(p, Shard) and p.dim != 0 for p in places):
        raise ValueError(f"the loss's logits shard only the batch; they "
                         f"are placed {places}")
    logits = redistribute(logits, mesh, places).to_local()
    targets, mask = (local_shard(whole(t), mesh, places)
                     for t in (targets, mask))
    logz = torch.logsumexp(logits, dim=-1)
    tl = torch.gather(logits, -1, targets[..., None])[..., 0]
    part = torch.sum((logz - tl) * mask.float())
    return DTensor.from_local(part, mesh, [
        Partial() if isinstance(p, Shard) else Replicate() for p in places],
        run_check=False)


def next_token_targets(x: torch.Tensor, batch: dict
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The hidden states that predict, their targets and the loss mask
    (``batch['loss_mask']`` when given, else ones): position t predicts
    token t + 1; behind an image prefix of n positions, position n - 1 + t
    predicts token t, so every text token is a target."""
    tokens = batch["tokens"]
    n_img = x.shape[1] - tokens.shape[1]          # 0 unless vlm
    pred = x[:, :-1] if n_img == 0 else x[:, n_img - 1:-1]
    targets = tokens[:, 1:] if n_img == 0 else tokens
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=x.device)
    elif n_img == 0:
        mask = mask[:, 1:]
    return pred, targets, mask


def loss_and_metrics(params: dict, batch: dict, config: ModelConfig
                     ) -> tuple[torch.Tensor, dict]:
    """The training loss: (the cross-entropy plus the MoE aux loss,
    {'loss': the cross-entropy, 'aux_loss'}), fp32 scalars."""
    x, positions = _embed_inputs(params, batch, config)
    x, aux, _ = _run_layers(x, params, config, positions, None)
    x = L.apply_norm(x, params["final_norm"], config)
    pred, targets, mask = next_token_targets(x, batch)
    loss = _chunked_ce(pred, params, config, targets, mask)
    return loss + aux, {"loss": loss, "aux_loss": aux}


# -- serving -----------------------------------------------------------------------
def init_cache(config: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    """'k', 'v': (L_full, batch, max_len, KH, hd) zeros in the activation
    dtype, a stack for the full layers (every layer without a pattern);
    with sliding layers also 'k_sliding', 'v_sliding': (L_sliding, batch,
    min(window, max_len), KH, hd), rolling buffers (``attention_layer``);
    'pos': 0. The bytes of each kind are the port's gauge
    ``kv_cache_bytes{kind}``, set here."""
    kinds = layer_kinds(config)
    cache: dict = {}
    for kind in KINDS:
        n = kinds.count(kind)
        if kind == "sliding" and not n:
            continue
        layer = attn.init_cache(
            config, batch, max_len, device,
            window=config.local_window if kind == "sliding" else 0)
        shape = (n,) + tuple(layer["k"].shape)
        ks, vs = _cache_keys(kind)
        cache[ks] = layer["k"].new_zeros(shape)
        cache[vs] = layer["v"].new_zeros(shape)
        get_registry().gauge(
            "kv_cache_bytes", "the serve cache's bytes by attention kind",
            labels={"kind": kind}).set(
                2 * cache[ks].numel() * cache[ks].element_size())
    cache["pos"] = 0
    return cache


def cache_specs(config: ModelConfig) -> dict:
    """Logical axes of ``init_cache``'s tree, each stack on its layers as
    the reference's (``repro/models/transformer.py:266``)."""
    kv = ("layers", "batch", "null", "kv_heads", "head_dim")
    specs = {"k": kv, "v": kv, "pos": ()}
    if "sliding" in layer_kinds(config):
        specs.update(k_sliding=kv, v_sliding=kv)
    return specs


def prefill(params: dict, batch: dict, config: ModelConfig,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Run the full prompt ``batch['tokens']`` (B, S), behind its image
    prefix for the VLM family, fill a fresh cache of ``max_len`` (default
    the whole sequence) slots, return last-token logits (B, 1, V). A cache
    shorter than the sequence keeps its first ``max_len`` positions, as
    the reference's does, so a VLM caller counts the image prefix in
    ``max_len``."""
    tokens = batch["tokens"]
    x, positions = _embed_inputs(params, batch, config)
    cache = zeros_logical(lambda dev: init_cache(
        config, tokens.shape[0], max_len or x.shape[1], dev),
        cache_specs(config), tokens.device)
    x, _, cache = _run_layers(x, params, config, positions, cache)
    x = L.apply_norm(x, params["final_norm"], config)
    return L.lm_logits(x[:, -1:], params["embed"], config), cache


def decode_step(params: dict, tokens: torch.Tensor, cache: dict,
                config: ModelConfig) -> tuple[torch.Tensor, dict]:
    """tokens: (B, 1) -> (logits (B, 1, V), the cache one token on)."""
    x, positions = _embed_inputs(params, {"tokens": tokens}, config,
                                 start_pos=cache["pos"])
    x, _, cache = _run_layers(x, params, config, positions, cache)
    x = L.apply_norm(x, params["final_norm"], config)
    return L.lm_logits(x, params["embed"], config), cache
