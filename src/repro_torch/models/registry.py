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
    param_specs(config) -> logical-axis spec tree (matches params)
    cache_specs(config) -> logical-axis spec tree (matches the cache)
A spec tree has the port's tree layout: a layer kept in a list takes the
reference's stacked spec without its leading "layers" axis.
``param_shapes`` draws a config's parameters on the meta device, shapes
and dtypes without memory (the reference's ``jax.eval_shape`` of
``init``).
"""
from __future__ import annotations

from types import ModuleType

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rglru, rwkv6, transformer, whisper

_FAMILIES: dict[str, ModuleType] = {"dense": transformer,
                                     "moe": transformer,
                                     "vlm": transformer,
                                     "hybrid": rglru,
                                     "audio": whisper,
                                     "ssm": rwkv6}


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device, so that a family's
    ``init`` draws its tensors there: shapes without memory or values."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def param_shapes(config: ModelConfig) -> dict:
    """The family's parameter tree on the meta device."""
    return get_model(config).init(_MetaGenerator(), config)


def get_model(config: ModelConfig) -> ModuleType:
    try:
        return _FAMILIES[config.family]
    except KeyError:
        raise ValueError(f"unknown model family {config.family!r}") from None
