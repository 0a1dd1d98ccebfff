"""rwkv6-7b [ssm] — 32L d_model=4096 (attention-free, 64 heads x 64)
d_ff=14336 vocab=65536 — Finch: data-dependent decay. Constant-size
state, no KV cache. [arXiv:2404.05892; hf]

The numbers of ``repro/configs/rwkv6_7b.py``, its ``remat`` included
(``"full"``, and ``"none"`` in ``reduced()``). The embeddings are not
scaled: the reference scales gemma's only.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    norm="layernorm",
    pos_embedding="none",
    rwkv_chunk=16,
    decay_lora=64,
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=4, head_dim=16, d_ff=128,
                          vocab_size=256, decay_lora=8, rwkv_chunk=4, remat="none")
