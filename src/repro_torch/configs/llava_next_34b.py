"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000, anyres tiling (frontend stubbed: precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The numbers of ``repro/configs/llava_next_34b.py``: 576 image embeddings
a request (one 24x24 anyres tile, the frontend a stub), prepended to the
token embeddings. ``pad_attention_heads`` pads the 56 heads to a mesh's
'model' axis where it does not divide them (64 on a 16-way axis) and pads
none without a mesh, so on one card it is the same function.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    hidden_act="silu",
    mlp_gated=True,
    norm="rmsnorm",
    rope_theta=5_000_000.0,
    num_image_tokens=576,          # one 24x24 anyres tile (stub embeddings)
    pad_attention_heads=True,      # heads % TP != 0: pad, don't replicate
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=2, head_dim=16, d_ff=128,
                          vocab_size=256, num_image_tokens=4, remat="none")
