"""mellum2-12b-a2.5b [moe] — 28L d_model=2304 32H (GQA kv=4) hd 128,
every layer sparse: 64 experts of 896 (SwiGLU) top 8, gates renormalised,
no shared expert; three sliding-window layers (1,024 keys) then one full
layer, seven times over; yarn RoPE on the full layers, default RoPE on
the sliding ones, both at θ 500,000; vocab 98,304, untied head.
[hf:JetBrains/Mellum2-12B-A2.5B-Instruct, config.json]

A configuration of the port alone: the JAX package has no such model, so
the plain reference it is held to is ``port_bench/reference/mellum2.py``
(``tests/test_torch_mellum2.py``). The published numbers are those of the
config: ``layer_types`` (three ``sliding_attention``, one
``full_attention``), ``sliding_window`` 1,024, ``num_experts`` 64,
``num_experts_per_tok`` 8, ``norm_topk_prob`` true, ``moe_intermediate_size``
896, ``rope_parameters`` (full: yarn, θ 500,000, factor 16,
``original_max_position_embeddings`` 8,192, ``beta_fast`` 32,
``beta_slow`` 1, ``attention_factor`` 1.27726; sliding: default, θ
500,000), ``rms_norm_eps`` 1e-6 (the port's RMSNorm epsilon),
``attention_bias`` false. Assumed, since the config defines none: no
QK-norm (the config has no key for it) and no multi-token-prediction head
(``described_as`` names one; serving does not use it). Dropless routing
(``moe_dropless``): the published model drops no slot, where the
capacity buffer of the reference's MoE would. ``_skip_blocks`` lets the
sliding layers' ``blocked`` prefill compute only the tiles inside the
window. The router's aux loss keeps the port's default weight.
"""
from repro_torch.configs.base import ModelConfig, Yarn

CONFIG = ModelConfig(
    name="mellum2-12b-a2.5b",
    family="moe",
    num_layers=28,
    d_model=2304,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=896,                      # per-expert
    vocab_size=98304,
    num_experts=64,
    experts_per_token=8,
    moe_dropless=True,
    hidden_act="silu",
    mlp_gated=True,
    norm="rmsnorm",
    tie_embeddings=False,
    rope_theta=500_000.0,
    attention_pattern=("sliding", "sliding", "sliding", "full"),
    local_window=1024,
    full_rope=Yarn(factor=16.0, original_max_position=8192, beta_fast=32.0,
                   beta_slow=1.0, attention_factor=1.2772588722239782),
    remat="full",
    sharding_overrides={"_skip_blocks": True},
)


def reduced() -> ModelConfig:
    """The same family at a CPU's size: the 3:1 pattern over 4 layers, a
    window of 8 (shorter than the tests' prompts), 8 experts top 2, yarn
    on the full layer with a pretraining length of 64, so that the ramp
    keeps the fastest frequency, blends the next and interpolates the
    rest."""
    return CONFIG.replace(
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=256, num_experts=8, experts_per_token=2,
        local_window=8, remat="none", attention_block_q=16,
        attention_block_kv=16,
        full_rope=Yarn(factor=4.0, original_max_position=64, beta_fast=32.0,
                       beta_slow=1.0, attention_factor=1.1386))
