"""The reference's parameters as the port's: how the tests give both
packages the same weights.

``repro.models.transformer.init`` and ``repro.models.rwkv6.init`` stack
each layer leaf along a leading (L, ...) axis for ``jax.lax.scan``, and
``repro.models.whisper.init`` stacks its ``encoder`` on
``encoder_layers`` and its ``decoder`` on ``num_layers``; the port keeps
lists of per-layer dicts. ``repro.models.rglru.init`` already keeps
per-layer dicts, keyed ``layer_NN``, and so does the port. The caller
passes the reference's tree with its leaves as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``); bf16 leaves arrive as
ml_dtypes' ``bfloat16`` and are reinterpreted bit for bit, so every leaf
keeps its dtype and value (rwkv6's fp32 ``w0`` and ``u`` in a bf16
model). The walk follows whatever keys the tree has, so a tied tree (no
``lm_head``), learned positions (``embed.pos``), a LayerNorm's ``bias``,
an ungated MLP (no ``w_gate``) and an MoE block arrive as they are: the
reference stacks the router on L as (L, D, E) in fp32 and the experts as
(L, E, D, F) and (L, E, F, D), and each layer takes its slice.

``state_from_jax`` carries a whole training state across: the
parameters, and the optimizer's ``m``, ``v`` and ``master`` trees, which
have the parameters' structure and are unstacked the same way, and its
``step``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def tensor_from_numpy(a: np.ndarray,
                      device: str | torch.device = "cpu") -> torch.Tensor:
    """A numpy array (bf16 included) as a tensor of the same dtype, on a
    copy (the reference's arrays are read-only)."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(node: Any, fn) -> Any:
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    return fn(node)


def _unstack(tree: dict, n: int, device: str | torch.device) -> list[dict]:
    """A tree whose leaves are stacked on a leading axis of ``n`` layers as
    ``n`` per-layer trees."""
    def layer(i: int) -> dict:
        def leaf(a: np.ndarray) -> torch.Tensor:
            a = np.asarray(a)
            if a.shape[:1] != (n,):
                raise ValueError(f"layer leaf of shape {a.shape} is not "
                                 f"stacked over {n} layers")
            return tensor_from_numpy(a[i], device)
        return _tree(tree, leaf)
    return [layer(i) for i in range(n)]


def params_from_jax(tree: dict, config: ModelConfig,
                    device: str | torch.device = "cpu") -> dict:
    """The reference's parameters (numpy leaves) as the port's, on
    ``device``: the stacked layer trees (a transformer's or rwkv6's
    ``layers``, whisper's ``encoder`` and ``decoder``) become lists of
    per-layer dicts; the hybrid family's per-layer dicts (``layer_NN``)
    stay as they are; every other leaf is copied whole, each in its
    dtype."""
    def whole(a: np.ndarray) -> torch.Tensor:
        return tensor_from_numpy(np.asarray(a), device)

    if config.family == "hybrid":
        return _tree(tree, whole)
    stacked = ({"encoder": config.encoder_layers,
                "decoder": config.num_layers} if config.family == "audio"
               else {"layers": config.num_layers})
    return {key: _unstack(node, stacked[key], device) if key in stacked
            else _tree(node, whole) for key, node in tree.items()}


def state_from_jax(state: dict, config: ModelConfig,
                   device: str | torch.device = "cpu") -> dict:
    """The reference's training state ({'params', 'opt': {'m', 'v',
    'step', and 'master' with fp32 master weights}}, numpy leaves) as the
    port's, on ``device``: every parameter-shaped tree through
    ``params_from_jax``, the step an int32 scalar tensor."""
    opt = state["opt"]
    out = {name: params_from_jax(opt[name], config, device)
           for name in ("m", "v", "master") if name in opt}
    out["step"] = tensor_from_numpy(np.asarray(opt["step"], np.int32),
                                    device)
    return {"params": params_from_jax(state["params"], config, device),
            "opt": out}
