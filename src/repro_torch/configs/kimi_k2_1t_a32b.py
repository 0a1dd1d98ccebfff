"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) hd 128
d_ff=2048 a expert, vocab=163840, MoE 384 experts top-8: about 1 T
parameters. [arXiv:2501.kimi2; unverified, as the reference says]

The numbers of ``repro/configs/kimi_k2_1t_a32b.py``, sized for 256-way
weight sharding: experts over 'model', and by its ``sharding_overrides``
their d_model and the embeddings over 'data' (``reduced()`` drops the
overrides, as the reference's does). At about 2 TB in bf16 it does not
fit one card: the port runs it at ``reduced()`` only, and at full width
takes only its specs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,                     # per-expert
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    capacity_factor=1.25,
    hidden_act="silu",
    mlp_gated=True,
    norm="rmsnorm",
    rope_theta=50_000.0,
    remat="full",
    sharding_overrides={"expert_in": "data", "embed_fsdp": "data"},
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=2, head_dim=16, d_ff=32,
                          vocab_size=256, num_experts=4,
                          experts_per_token=2, remat="none",
                          sharding_overrides={})
