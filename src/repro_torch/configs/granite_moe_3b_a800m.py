"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) hd 64
d_ff=512 a expert, vocab=49155, MoE 40 experts top-8, tied embeddings.
[hf:ibm-granite/granite-3.0-3b-a800m-base]

The numbers of ``repro/configs/granite_moe_3b_a800m.py``. Its docstring
cites ``granite-3.0-1b-a400m-base``, but its numbers (32 layers, 1,536
wide, 24/8 heads, 40 experts top 8 of 512, vocabulary 49,155) are those of
``granite-3.0-3b-a800m-base``, named here. Granite's published embedding,
attention, residual and logits multipliers are left out of both packages
on purpose: the port computes what the reference computes. ``remat``
is the reference's: ``"full"``, and ``"none"`` in ``reduced()``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,                      # per-expert
    vocab_size=49155,
    num_experts=40,
    experts_per_token=8,
    capacity_factor=1.25,
    hidden_act="silu",
    mlp_gated=True,
    norm="rmsnorm",
    tie_embeddings=True,
    rope_theta=10_000.0,
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=2, head_dim=16, d_ff=32,
                          vocab_size=256, num_experts=4,
                          experts_per_token=2, remat="none")
