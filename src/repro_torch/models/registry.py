"""Model registry: family -> module implementing the serve API.

The counterpart of ``repro/models/registry.py``: the dense, MoE and VLM
families, all served by the transformer, the hybrid family
(recurrentgemma), served by ``rglru``, the audio family (whisper), served
by ``whisper``, and the ssm family (rwkv6), served by ``rwkv6``. API of a
family module:
    init(gen, config) -> params
    prefill(params, batch, config, max_len) -> (last_logits, cache)
    decode_step(params, tokens, cache, config) -> (logits, cache)
    init_cache(config, batch, max_len, device) -> cache
    loss_and_metrics(params, batch, config) -> (loss, metrics)
"""
from __future__ import annotations

from types import ModuleType

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rglru, rwkv6, transformer, whisper

_FAMILIES: dict[str, ModuleType] = {"dense": transformer,
                                     "moe": transformer,
                                     "vlm": transformer,
                                     "hybrid": rglru,
                                     "audio": whisper,
                                     "ssm": rwkv6}


def get_model(config: ModelConfig) -> ModuleType:
    try:
        return _FAMILIES[config.family]
    except KeyError:
        raise ValueError(f"unknown model family {config.family!r}") from None
