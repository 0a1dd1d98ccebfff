"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE, LayerNorm, non-gated GELU MLP.
[arXiv:2402.19173; hf]

The numbers of ``repro/configs/starcoder2_3b.py``, head padding
included: 24 heads pad to 32 on a 16-way 'model' axis, and to none
without a mesh.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    hidden_act="gelu",
    mlp_gated=False,
    norm="layernorm",
    rope_theta=100_000.0,
    pad_attention_heads=True,      # heads % TP != 0: pad, don't replicate
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=2, head_dim=16, d_ff=128,
                          vocab_size=256, remat="none")
