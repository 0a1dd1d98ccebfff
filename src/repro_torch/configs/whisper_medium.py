"""whisper-medium [audio] — 24L(enc)+24L(dec) d_model=1024 16H (MHA kv=16)
d_ff=4096 vocab=51865 — enc-dec; conv frontend STUB (precomputed frame
embeddings, 1500 frames). [arXiv:2212.04356; unverified]

The numbers of ``repro/configs/whisper_medium.py``, its ``remat``
included (``"full"``, and ``"none"`` in ``reduced()``). The embeddings are
not scaled: the reference scales gemma's only.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,                 # decoder
    encoder_layers=24,
    encoder_seq=1500,
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    hidden_act="gelu",
    mlp_gated=False,
    norm="layernorm",
    pos_embedding="learned",
    max_position=32_776,
    tie_embeddings=True,
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=2, encoder_layers=2, encoder_seq=12,
                          d_model=64, num_heads=4, num_kv_heads=4,
                          head_dim=16, d_ff=128, vocab_size=256,
                          max_position=128, remat="none")
