"""Shared model layers: RMSNorm, the SwiGLU MLP, embeddings, RoPE,
initialisers.

The counterpart of ``repro/models/layers.py``, in the same pure-function
style: parameters are plain dicts of tensors and every layer is a function
of them. The initialisers draw from an explicit ``torch.Generator`` with the
reference's standard deviations (an fp32 normal times std, then cast); the
draws differ from ``jax.random``'s, so the tests hand both packages the same
weights through ``repro_torch.models.convert``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


# -- initialisers --------------------------------------------------------------
def normal_init(gen: torch.Generator, shape: tuple[int, ...], std: float,
                dtype: torch.dtype) -> torch.Tensor:
    """An fp32 standard normal from ``gen`` (on ``gen``'s device) times
    ``std``, cast to ``dtype``."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * std).to(dtype)


# -- norms -------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def init_norm(config: ModelConfig, dtype: torch.dtype,
              device: torch.device) -> dict:
    return {"scale": torch.ones(config.d_model, dtype=dtype, device=device)}


# -- dense MLP (SwiGLU) ------------------------------------------------------
def init_mlp(gen: torch.Generator, config: ModelConfig,
             dtype: torch.dtype) -> dict:
    d, f = config.d_model, config.d_ff
    std_in = 1.0 / math.sqrt(d)
    std_out = 1.0 / math.sqrt(f) / math.sqrt(2.0 * config.num_layers)
    return {"w_up": normal_init(gen, (d, f), std_in, dtype),
            "w_down": normal_init(gen, (f, d), std_out, dtype),
            "w_gate": normal_init(gen, (d, f), std_in, dtype)}


def mlp(x: torch.Tensor, params: dict, config: ModelConfig) -> torch.Tensor:
    dtype = x.dtype
    up = x @ params["w_up"].to(dtype)
    gate = F.silu(x @ params["w_gate"].to(dtype))
    return (gate * up) @ params["w_down"].to(dtype)


# -- embeddings ----------------------------------------------------------------
def init_embedding(gen: torch.Generator, config: ModelConfig,
                   dtype: torch.dtype) -> dict:
    d, V = config.d_model, config.vocab_size
    return {"tok": normal_init(gen, (V, d), 1.0 / math.sqrt(d), dtype),
            "lm_head": normal_init(gen, (d, V), 1.0 / math.sqrt(d), dtype)}


def embed_tokens(tokens: torch.Tensor, params: dict,
                 config: ModelConfig) -> torch.Tensor:
    return params["tok"].to(config.activation_dtype)[tokens]


def lm_logits(x: torch.Tensor, params: dict,
              config: ModelConfig) -> torch.Tensor:
    return x @ params["lm_head"].to(x.dtype)


# -- RoPE ----------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | None = None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). The
    split-halves form, angles in fp32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # (hd/2,)
    angles = positions[..., :, None].float() * freqs            # (..., S, hd/2)
    angles = angles[..., :, None, :]                            # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
