"""Model configuration, trimmed to what the serve paths of the ported
families read: dense, MoE, hybrid, audio (whisper) and ssm (rwkv6).

The counterpart of ``repro/configs/base.py:ModelConfig``: the same field
names and defaults for the fields kept, but ``attention_impl``, whose
values are the port's own (below), and one field of the port's own,
``embed_scale``. The reference keeps dtypes as strings (``dtype``,
``param_dtype``); ``DTYPES`` maps them to torch dtypes. Kept are the
fields the ported archs set: the MLP's activation and gating, RMSNorm
(with gemma's (1 + w) offset) or LayerNorm, tied embeddings, the position
embedding (RoPE with its theta, learned positions with their table's
size, or none), the logit soft cap, the MoE block's experts, top-k,
capacity factor and aux-loss weight, the hybrid family's block pattern,
sliding window, RG-LRU width and conv width, rwkv6's WKV chunk and decay
LoRA rank, and whisper's encoder depth and frame count with
``is_encoder_decoder``, which the reference sets and reads nowhere. The
reference scales gemma's and recurrentgemma's embeddings by sqrt(d_model)
on a test of the arch's name (``layers.py:embed_tokens``); here
``embed_scale`` says so in the arch's config file. The reference's
``pad_attention_heads`` pads the heads to a mesh's tensor-parallel degree
and pads 0 heads without a mesh; the port has no mesh yet, so the field
comes with the mesh (ROADMAP Queue 1 item 9), as do ``sharding_overrides``
(kimi-k2's expert and embedding sharding) and the all-to-all MoE path they
select. The VLM block's field (``num_image_tokens``), remat and scan come
with the slice that ports an arch setting them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

DTYPES: dict[str, torch.dtype] = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int                 # query heads
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // num_heads
    # layer flavours
    hidden_act: str = "silu"       # silu | gelu (tanh form) | relu2
    mlp_gated: bool = True
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_offset: bool = False      # gemma-style (1 + w) RMSNorm scale
    rope_theta: float = 10_000.0
    pos_embedding: str = "rope"    # rope | learned | none
    logits_soft_cap: float = 0.0   # cap · tanh(logits / cap) when > 0
    tie_embeddings: bool = False
    embed_scale: bool = False      # embeddings x sqrt(d_model) (gemma)
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    # hybrid / recurrent
    block_pattern: tuple[str, ...] = ("attn",)   # cycled over layers
    local_window: int = 0          # sliding window of the attention blocks
    lru_width: int = 0             # RG-LRU state width (0 => d_model)
    conv_width: int = 4
    # ssm (rwkv)
    rwkv_chunk: int = 16
    decay_lora: int = 64
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0           # precomputed frame-embedding length
    is_encoder_decoder: bool = False
    # numerics / execution
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "bfloat16"
    # flash: the CUDA kernel for a causal prefill on the card, naive
    # elsewhere; naive: naive everywhere. The reference's blocked and
    # triangular schedules are not ported and are refused.
    attention_impl: str = "flash"
    # max positions for learned embeddings (0 => 8,192)
    max_position: int = 0

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def activation_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def parameter_dtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
