"""Architecture registry of the port: the configs it can serve and train.

The counterpart of ``repro/configs/__init__.py:get_config``, over the
ported archs only. Every module exports ``CONFIG`` (the published numbers)
and ``reduced()`` (a tiny variant of the same family for CPU tests).
"""
from __future__ import annotations

import importlib

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
}
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


__all__ = ["ARCHS", "DTYPES", "SHAPES", "SMOKE_SHAPE", "ModelConfig",
           "OptimizerConfig", "RunConfig", "ShapeConfig", "WAITING",
           "applicable_shapes", "get_config"]
