"""gemma-7b [dense] — 28L d_model=3072 16H (MHA kv=16) d_ff=24576
vocab=256000 — GeGLU, head_dim=256, tied embeddings, (1+w) RMSNorm,
sqrt(d) embedding scale. [arXiv:2403.08295; hf]

The numbers of ``repro/configs/gemma_7b.py``, and
``embed_scale``, which the reference derives from the name.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    hidden_act="gelu",
    mlp_gated=True,
    norm="rmsnorm",
    norm_offset=True,
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=10_000.0,
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=4, head_dim=16, d_ff=128,
                          vocab_size=256, remat="none")
