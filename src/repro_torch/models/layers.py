"""Shared model layers: norms, activations, MLPs, embeddings (token and
learned position tables), RoPE, initialisers, the cross-entropy loss and
the training step's activation checkpointing (``remat``).

The counterpart of ``repro/models/layers.py``, in the same pure-function
style: parameters are plain dicts of tensors and every layer is a function
of them. The initialisers draw from an explicit ``torch.Generator`` with the
reference's standard deviations (an fp32 normal times std, then cast); the
draws differ from ``jax.random``'s, so the tests hand both packages the same
weights through ``repro_torch.models.convert``. Where the reference's
arithmetic rounds in a particular place, so does this: both norms in fp32
and cast once, GELU in its tanh form (``jax.nn.gelu``'s default), and
gemma's sqrt(d_model) rounded to the activation dtype before it scales.
"""
from __future__ import annotations

import functools
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, Yarn
from repro_torch.parallel.sharding import (current_mesh, current_rules,
                                           logical_constraint, use_mesh)


# -- initialisers --------------------------------------------------------------
def normal_init(gen: torch.Generator, shape: tuple[int, ...], std: float,
                dtype: torch.dtype) -> torch.Tensor:
    """An fp32 standard normal from ``gen`` (on ``gen``'s device) times
    ``std``, cast to ``dtype``."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * std).to(dtype)


# -- norms -------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            offset: bool = False) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w = scale.float()
    if offset:                     # gemma-style (1 + w)
        w = 1.0 + w
    return (y * w).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """In fp32 with the population variance (``jnp.var``), scale and bias
    applied in fp32, cast once."""
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(x: torch.Tensor, params: dict,
               config: ModelConfig) -> torch.Tensor:
    if config.norm == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    return rmsnorm(x, params["scale"], offset=config.norm_offset)


def init_norm(config: ModelConfig, dtype: torch.dtype,
              device: torch.device) -> dict:
    """LayerNorm: scale 1, bias 0. RMSNorm: scale 1, or 0 with the (1 + w)
    offset."""
    d = config.d_model
    if config.norm == "layernorm":
        return {"scale": torch.ones(d, dtype=dtype, device=device),
                "bias": torch.zeros(d, dtype=dtype, device=device)}
    fill = torch.zeros if config.norm_offset else torch.ones
    return {"scale": fill(d, dtype=dtype, device=device)}


def norm_specs(config: ModelConfig) -> dict:
    """Logical axes of ``init_norm``'s tree."""
    if config.norm == "layernorm":
        return {"scale": ("embed",), "bias": ("embed",)}
    return {"scale": ("embed",)}


# -- activations -----------------------------------------------------------------
def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":             # jax.nn.gelu's default: the tanh form
        return F.gelu(x, approximate="tanh")
    if kind == "relu2":            # nemotron / minitron squared ReLU
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {kind!r}")


# -- dense MLP -----------------------------------------------------------------
def init_mlp(gen: torch.Generator, config: ModelConfig,
             dtype: torch.dtype) -> dict:
    """w_up and w_down, and w_gate when the MLP is gated."""
    d, f = config.d_model, config.d_ff
    std_in = 1.0 / math.sqrt(d)
    std_out = 1.0 / math.sqrt(f) / math.sqrt(2.0 * config.num_layers)
    params = {"w_up": normal_init(gen, (d, f), std_in, dtype),
              "w_down": normal_init(gen, (f, d), std_out, dtype)}
    if config.mlp_gated:
        params["w_gate"] = normal_init(gen, (d, f), std_in, dtype)
    return params


def mlp_specs(config: ModelConfig) -> dict:
    """Logical axes of ``init_mlp``'s tree."""
    specs = {"w_up": ("embed_fsdp", "ff"), "w_down": ("ff", "embed_fsdp")}
    if config.mlp_gated:
        specs["w_gate"] = ("embed_fsdp", "ff")
    return specs


def seq_whole(x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) activations with the sequence whole on every rank, under
    a mesh: before a projection, the all-gather of Megatron's sequence
    parallelism, and after a projection over sharded columns, the sum of
    its partial products. XLA places both for the reference. The port
    places them by hand, because DTensor flattens a tensor whose batch and
    sequence are sharded at once (the product's input, or its gradient
    in the backward pass) into strided shards, whose redistributions it
    plans by a search that takes seconds on a 3-D mesh."""
    return logical_constraint(x, "batch", "seq", "embed")


def mlp(x: torch.Tensor, params: dict, config: ModelConfig) -> torch.Tensor:
    """Gated: act(x W_gate) * (x W_up), then W_down; ungated: act(x W_up),
    then W_down."""
    x = seq_whole(x)
    dtype = x.dtype
    up = x @ params["w_up"].to(dtype)
    if config.mlp_gated:
        h = activation(x @ params["w_gate"].to(dtype), config.hidden_act) * up
    else:
        h = activation(up, config.hidden_act)
    h = logical_constraint(h, "batch", "seq", "ff")
    return seq_whole(h @ params["w_down"].to(dtype))


# -- embeddings ----------------------------------------------------------------
def init_embedding(gen: torch.Generator, config: ModelConfig,
                   dtype: torch.dtype) -> dict:
    """The token table; with learned positions the position table ``pos``
    of ``max_position`` rows (8,192 when 0) at std 0.02; the head unless
    the embeddings are tied."""
    d, V = config.d_model, config.vocab_size
    params = {"tok": normal_init(gen, (V, d), 1.0 / math.sqrt(d), dtype)}
    if config.pos_embedding == "learned":
        params["pos"] = normal_init(gen, (config.max_position or 8192, d),
                                    0.02, dtype)
    if not config.tie_embeddings:
        params["lm_head"] = normal_init(gen, (d, V), 1.0 / math.sqrt(d),
                                        dtype)
    return params


def embedding_specs(config: ModelConfig) -> dict:
    """Logical axes of ``init_embedding``'s tree."""
    specs = {"tok": ("vocab", "embed_fsdp")}
    if config.pos_embedding == "learned":
        specs["pos"] = ("null", "embed_fsdp")
    if not config.tie_embeddings:
        specs["lm_head"] = ("embed_fsdp", "vocab")
    return specs


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``, the rows of a table. A DTensor table's by
    ``F.embedding``, whose backward DTensor shards (its strategy for the
    indexing's backward, ``index_put``, fails in torch 2.11), with the
    pending sum of a row-sharded table taken at once: the all-reduce of a
    vocab-parallel embedding (DTensor's masked pending sum breaks when it
    meets another placement)."""
    from repro_torch.parallel.sharding import is_dtensor, redistribute, \
        summed
    if not is_dtensor(table):
        return table[idx]
    out = F.embedding(idx, table)
    return redistribute(out, out.device_mesh, summed(out.placements))


def embed_tokens(tokens: torch.Tensor, params: dict,
                 config: ModelConfig) -> torch.Tensor:
    """The table's rows in the activation dtype; with ``embed_scale``, times
    sqrt(d_model) rounded to that dtype first (55.5 for gemma-7b in bf16),
    as the reference multiplies."""
    x = lookup(params["tok"].to(config.activation_dtype), tokens)
    if config.embed_scale:
        x = x * torch.tensor(math.sqrt(config.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def lm_logits(x: torch.Tensor, params: dict,
              config: ModelConfig) -> torch.Tensor:
    """The head's logits; with ``logits_soft_cap`` > 0, capped as
    ``cap · tanh(logits / cap)`` in the logits' dtype."""
    if config.tie_embeddings:
        logits = x @ params["tok"].to(x.dtype).T
    else:
        logits = x @ params["lm_head"].to(x.dtype)
    if config.logits_soft_cap > 0:
        cap = config.logits_soft_cap
        logits = cap * torch.tanh(logits / cap)
    return logits


# -- RoPE ----------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | None = None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def yarn_frequencies(head_dim: int, theta: float, yarn: Yarn,
                     device: torch.device | None = None
                     ) -> tuple[torch.Tensor, float]:
    """Yarn's inverse frequencies and its cos/sin scale, as transformers'
    ``_compute_yarn_parameters`` computes them (``truncate`` on): the
    default frequencies (extrapolated) and those over ``factor``
    (interpolated), blended by a linear ramp between the dimensions at
    which the pretraining length turns ``beta_fast`` and ``beta_slow``
    times; the scale is ``attention_factor``."""
    pos = theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                 device=device) / head_dim)

    def dim_at(rotations: float) -> float:
        return (head_dim * math.log(yarn.original_max_position
                                    / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(dim_at(yarn.beta_fast)), 0)
    high = min(math.ceil(dim_at(yarn.beta_slow)), head_dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(head_dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    keep = 1 - ramp                 # the extrapolated share of each dim
    return (1.0 / (yarn.factor * pos) * (1 - keep) + 1.0 / pos * keep,
            yarn.attention_factor)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float, yarn: Yarn | None = None) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). The
    split-halves form, angles in fp32; with ``yarn``, its frequencies and
    cos and sin times its scale (``yarn_frequencies``)."""
    if yarn is None:
        freqs, scale = rope_frequencies(x.shape[-1], theta, x.device), 1.0
    else:
        freqs, scale = yarn_frequencies(x.shape[-1], theta, yarn, x.device)
    angles = positions[..., :, None].float() * freqs            # (..., S, hd/2)
    angles = angles[..., :, None, :]                            # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    if scale != 1.0:
        cos, sin = cos * scale, sin * scale
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- losses --------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Token-mean cross entropy in fp32 with optional z-loss; with ``mask``
    the masked mean, over at least one token."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    target_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = logz - target_logit
    if z_loss > 0:
        nll = nll + z_loss * torch.square(logz)
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


# -- activation checkpointing ------------------------------------------------------
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Keep the outputs of matmuls without batch dimensions, recompute the
    rest: ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``."""
    if op in _MATMULS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def layer_policy(config: ModelConfig) -> str:
    """The policy of a whole layer of rglru, rwkv6 and whisper, which the
    reference checkpoints whole for any ``remat`` but ``"none"``."""
    return "none" if config.remat == "none" else "full"


def remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under activation checkpointing while autograd records:
    ``"full"`` keeps only its inputs and recomputes the rest in the
    backward pass (``jax.checkpoint``), ``"dots"`` also keeps the outputs
    of its unbatched matmuls, ``"none"`` keeps everything. The values are
    the same under every policy; with grad off ``fn`` runs as it is. The
    recompute runs under the mesh and rules active at the forward pass:
    on the card autograd runs the backward pass on threads of its own, to
    which ``use_mesh``'s thread-local context does not reach."""
    if policy == "none":
        return fn
    if policy not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {policy!r}")
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        mesh, rules = current_mesh(), current_rules()

        def in_context(*a):
            with use_mesh(mesh, rules):
                return fn(*a)

        return checkpoint(in_context, *args, use_reentrant=False, **kw)

    return run
