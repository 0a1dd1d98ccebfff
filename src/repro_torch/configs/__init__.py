"""Architecture registry of the port: the configs it can serve and train.

The counterpart of ``repro/configs/__init__.py``, over the ported archs.
Every module exports ``CONFIG`` (the published numbers) and ``reduced()``
(a tiny variant of the same family for CPU tests). ``input_specs`` gives
a cell's inputs as meta-device tensors, the shapes and dtypes without
memory, where the reference gives ``ShapeDtypeStruct``s; with
``batch_specs_logical`` they feed ``training.shardings_for``.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import (DTYPES, SHAPES, SMOKE_SHAPE,
                                      ModelConfig, OptimizerConfig,
                                      RunConfig, ShapeConfig,
                                      applicable_shapes)

ARCHS: dict[str, str] = {
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "mellum2-12b-a2.5b": "repro_torch.configs.mellum2_12b_a2_5b",
}
# the archs of the port alone, which the JAX package does not have: each
# is held to a plain reference of its own (port_bench/reference/)
PORT_ONLY: tuple[str, ...] = ("mellum2-12b-a2.5b",)
# the archs both packages have, which tests hold to the JAX package
REFERENCE_ARCHS: tuple[str, ...] = tuple(a for a in ARCHS
                                         if a not in PORT_ONLY)
# the reference's archs not yet ported, each with the ROADMAP Queue 1 item
# it waits for: none since llava-next-34b
WAITING: dict[str, int] = {}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch in WAITING:
        raise KeyError(f"arch {arch!r} waits for ROADMAP Queue 1 item "
                       f"{WAITING[arch]}; ported: {sorted(ARCHS)}")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; ported: {sorted(ARCHS)}")
    mod = importlib.import_module(ARCHS[arch])
    return mod.reduced() if reduced else mod.CONFIG


def all_archs() -> list[str]:
    return list(ARCHS)


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(config: ModelConfig, shape: ShapeConfig) -> dict:
    """One (arch x shape) cell's inputs as meta tensors
    (``repro/configs/__init__.py:49``): train and prefill the token batch
    (int64, the port's token dtype), behind the image embeddings of a VLM
    or beside the frames of an audio model; decode one token a row and
    the cache of ``seq_len`` positions."""
    B, S = shape.global_batch, shape.seq_len
    act, tok = config.activation_dtype, torch.int64
    if shape.kind in ("train", "prefill"):
        if config.family == "vlm":
            n_img = config.num_image_tokens
            batch = {"tokens": _meta((B, S - n_img), tok),
                     "image_embeds": _meta((B, n_img, config.d_model), act)}
        elif config.family == "audio":
            batch = {"tokens": _meta((B, S), tok),
                     "frames": _meta((B, config.encoder_seq,
                                      config.d_model), act)}
        else:
            batch = {"tokens": _meta((B, S), tok)}
        return {"batch": batch}
    from repro_torch.models.registry import get_model
    cache = get_model(config).init_cache(config, B, S,
                                         torch.device("meta"))
    return {"tokens": _meta((B, 1), tok), "cache": cache}


def batch_specs_logical(config: ModelConfig, shape: ShapeConfig) -> dict:
    """Logical axes of ``input_specs``' trees
    (``repro/configs/__init__.py:79``)."""
    if shape.kind in ("train", "prefill"):
        if config.family == "vlm":
            return {"batch": {"tokens": ("batch", "seq"),
                              "image_embeds": ("batch", "seq", "embed")}}
        if config.family == "audio":
            return {"batch": {"tokens": ("batch", "seq"),
                              "frames": ("batch", "frames", "embed")}}
        return {"batch": {"tokens": ("batch", "seq")}}
    from repro_torch.models.registry import get_model
    return {"tokens": ("batch", "seq"),
            "cache": get_model(config).cache_specs(config)}


__all__ = ["ARCHS", "DTYPES", "PORT_ONLY", "REFERENCE_ARCHS", "SHAPES",
           "SMOKE_SHAPE", "ModelConfig", "OptimizerConfig", "RunConfig",
           "ShapeConfig", "WAITING", "all_archs", "applicable_shapes",
           "batch_specs_logical", "get_config", "input_specs"]
