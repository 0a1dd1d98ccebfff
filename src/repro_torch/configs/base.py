"""Model, shape, optimizer and run configuration of the ported families:
dense, MoE, VLM (llava), hybrid, audio (whisper) and ssm (rwkv6).

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
LoRA rank, whisper's encoder depth and frame count with
``is_encoder_decoder``, which the reference sets and reads nowhere, the VLM
image prefix's length (``num_image_tokens``), the training step's
``remat`` policy, and the attention's schedule: ``attention_impl``, its
tiles ``attention_block_q`` and ``attention_block_kv``, and
``sharding_overrides``, the rule table's overrides of the mesh
(``parallel/sharding.py``), whose ``_skip_blocks`` key the attention's
dispatch also reads (``models/attention.py:attention_core``). The
reference scales
gemma's and recurrentgemma's embeddings by sqrt(d_model) on a test of the
arch's name (``layers.py:embed_tokens``); here ``embed_scale`` says so in
the arch's config file. ``pad_attention_heads`` pads the query heads
(and the repeated K/V) with zero heads to the next multiple of a mesh's
'model' axis when that axis does not divide them, and pads none without
a mesh (``models/attention.py:attention_layer``). The ``_moe_impl: "a2a"``
override selects the all-to-all MoE path and ``_moe_pad_experts`` its
expert padding (``models/moe.py``). ``scan_layers`` has no counterpart: the port runs its layers in a
Python loop.

Fields of the port alone, for configurations the reference does not
have (mellum2-12b-a2.5b): ``attention_pattern``, the attention kind of
each layer of the dense/MoE transformer, cycled over the layers ("full",
or "sliding" over ``local_window`` keys); ``full_rope``, the full
layers' yarn RoPE (``Yarn``, transformers' ``_compute_yarn_parameters``;
the sliding layers keep default RoPE at ``rope_theta``); and
``moe_dropless``, routing with no slot dropped (``models/moe.py:
moe_layer_dropless``). Their defaults keep every other configuration
as it was: no pattern, default RoPE, the capacity buffer.

``ShapeConfig``, ``SHAPES``, ``SMOKE_SHAPE``, ``applicable_shapes``,
``OptimizerConfig`` and ``RunConfig`` are the reference's, with its names
and defaults. ``OptimizerConfig.zero1`` and ``compression`` are the
reference's GSPMD options: ``optim/adamw.py`` shards its state over a
mesh's 'data' axis by ``zero1`` and, as the reference's, never reads
``compression``; the data-parallel trainer (``parallel/dp.py``) reads
neither, as the reference's does: it always shards its optimizer state
and takes its compression as an argument.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

DTYPES: dict[str, torch.dtype] = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


@dataclass(frozen=True)
class Yarn:
    """Yarn RoPE (arXiv:2309.00071) as transformers' ``rope_type:
    "yarn"`` gives it: the context ``factor``, the pretraining length
    ``original_max_position``, the ramp's rotation bounds ``beta_fast``
    and ``beta_slow``, and ``attention_factor``, which scales cos and
    sin."""
    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: float = 1.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | vlm | hybrid | audio | ssm
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
    moe_dropless: bool = False     # route every slot, none dropped
    # hybrid / recurrent
    block_pattern: tuple[str, ...] = ("attn",)   # cycled over layers
    local_window: int = 0          # sliding window of the attention blocks
    # dense/MoE: each layer's attention, cycled: "full" | "sliding"
    attention_pattern: tuple[str, ...] = ()
    full_rope: Yarn | None = None  # yarn RoPE of the full layers
    lru_width: int = 0             # RG-LRU state width (0 => d_model)
    conv_width: int = 4
    # ssm (rwkv)
    rwkv_chunk: int = 16
    decay_lora: int = 64
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0           # precomputed frame-embedding length
    is_encoder_decoder: bool = False
    # vlm (llava)
    num_image_tokens: int = 0      # precomputed image embeddings a request
    # numerics / execution
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "bfloat16"
    remat: str = "none"            # none | full | dots (training only)
    # flash | naive | blocked | triangular: flash is the reference's
    # pallas, the CUDA kernel for a causal, window-free call on the card;
    # the dispatch is models/attention.py:attention_core
    attention_impl: str = "flash"
    attention_block_q: int = 512
    attention_block_kv: int = 1024
    pad_attention_heads: bool = False  # pad H to the mesh's 'model' axis
    # logical axis -> mesh axes overrides of the rule table, and the
    # "_skip_blocks" option of the attention's dispatch
    sharding_overrides: dict = field(default_factory=dict, hash=False,
                                     compare=False)
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

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


# The assigned shape set (identical across the LM pool).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

SMOKE_SHAPE = ShapeConfig("smoke", 64, 2, "train")


def applicable_shapes(config: ModelConfig) -> list[str]:
    """The assigned shapes an arch runs: ``long_500k`` only for the
    sub-quadratic families."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if config.is_subquadratic:
        names.append("long_500k")
    return names


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    zero1: bool = True             # shard the optimizer state over 'data'
    master_fp32: bool = True
    state_dtype: str = "float32"   # m/v moments dtype
    compression: str | None = None  # int8 gradient compression (DP path)


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    optimizer: OptimizerConfig = OptimizerConfig()
    seed: int = 0
    checkpoint_dir: str | None = None
    checkpoint_every: int = 100
