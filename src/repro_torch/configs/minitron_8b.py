"""minitron-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000 — pruned nemotron (squared-ReLU MLP, untied 256k vocab).
[arXiv:2407.14679; hf]

The numbers of ``repro/configs/minitron_8b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    hidden_act="relu2",            # nemotron squared ReLU
    mlp_gated=False,
    norm="layernorm",
    rope_theta=10_000.0,
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=2, head_dim=16, d_ff=128,
                          vocab_size=256, remat="none")
