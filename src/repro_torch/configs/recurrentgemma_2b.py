"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, pattern (rec, rec, attn),
window 2048, head_dim=256, tied embeddings, logits soft-cap 30.
[arXiv:2402.19427; hf]

The numbers of ``repro/configs/recurrentgemma_2b.py``, and
``embed_scale``, which the reference derives from the name. ``remat`` is
the reference's ``"full"``, kept by ``reduced()`` as the reference's
keeps it. ``pad_attention_heads`` pads the 10 heads to a mesh's 'model'
axis where it does not divide them; without a mesh no head is padded.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    hidden_act="gelu",
    mlp_gated=True,
    norm="rmsnorm",
    norm_offset=True,
    tie_embeddings=True,
    embed_scale=True,
    block_pattern=("rec", "rec", "attn"),
    local_window=2048,
    lru_width=2560,
    conv_width=4,
    logits_soft_cap=30.0,
    pad_attention_heads=True,      # heads % TP != 0: pad, don't replicate
    rope_theta=10_000.0,
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=3, d_model=64, num_heads=4,
                          num_kv_heads=1, head_dim=16, d_ff=128,
                          vocab_size=256, local_window=8, lru_width=64)
