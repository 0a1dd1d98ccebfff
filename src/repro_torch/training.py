"""Train and serve step functions: the model API times the optimizer.

The counterpart of ``repro/training.py``. ``build_train_step`` and
``build_serve_fns`` produce the step functions that the streaming trainer
(``launch/train.py``) and the server (``launch/serve.py``) run; the
reference's ``shardings_for`` and ``lower_cell`` attach a mesh's specs and
come with the port's mesh (ROADMAP Queue 1 item 9). The data-parallel
step over a process group is ``parallel/dp.py``.

The train step takes gradients by autograd through the config's attention
schedule, as the reference's ``jax.grad`` goes through its ``lax.scan``:
``naive``, ``blocked`` and ``triangular`` as asked, and ``flash`` (the
default) as ``blocked``, the reference's default: the reference never
trains through its Pallas kernel, which has no backward pass, nor can the
port through its flash kernel, which refuses inputs that require grad.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw_update, init_opt_state
from repro_torch.utils import tree_leaves, tree_map


def loss_and_grads(params: dict, batch: dict, config: ModelConfig
                   ) -> tuple[torch.Tensor, dict, dict]:
    """``jax.value_and_grad`` of the family's ``loss_and_metrics`` with
    respect to ``params``: (the loss, its metrics, the gradients in the
    parameters' tree and dtypes). A parameter the loss does not reach gets
    a zero gradient, as ``jax.grad`` gives it. The loss and metrics are
    detached."""
    model = get_model(config)
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = model.loss_and_metrics(live, batch, config)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, grads)])
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), live))


def train_config(config: ModelConfig) -> ModelConfig:
    """The config a train step runs: ``flash``, which has no backward pass,
    as ``blocked``; any other schedule as it is."""
    if config.attention_impl == "flash":
        return config.replace(attention_impl="blocked")
    return config


def build_train_step(config: ModelConfig, opt: OptimizerConfig
                     ) -> Callable[[dict, dict], tuple[dict, dict]]:
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradients with respect to ``state['params']`` (``loss_and_grads``, on
    ``train_config``'s schedule), then one AdamW step, written into
    ``state`` in place (the reference donates it). Metrics: 'loss',
    'aux_loss', 'lr', 'grad_norm' and 'total_loss', fp32 scalars on the
    state's device."""
    config = train_config(config)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        loss, metrics, grads = loss_and_grads(state["params"], batch, config)
        params, opt_state, opt_metrics = adamw_update(
            state["params"], grads, state["opt"], opt)
        return ({"params": params, "opt": opt_state},
                {**metrics, **opt_metrics, "total_loss": loss})

    return train_step


def build_serve_fns(config: ModelConfig) -> tuple[Callable, Callable]:
    """``prefill(params, batch, max_len=None)`` and ``decode_step(params,
    tokens, cache)`` of the config's family."""
    model = get_model(config)

    def prefill(params: dict, batch: dict, max_len: int | None = None
                ) -> tuple[torch.Tensor, dict]:
        return model.prefill(params, batch, config, max_len=max_len)

    def decode_step(params: dict, tokens: torch.Tensor, cache: dict
                    ) -> tuple[torch.Tensor, dict]:
        return model.decode_step(params, tokens, cache, config)

    return prefill, decode_step


def init_state(gen: torch.Generator, config: ModelConfig,
               opt: OptimizerConfig) -> dict:
    """{'params': the family's ``init`` drawn from ``gen`` on its device,
    'opt': ``init_opt_state``}; every leaf its own tensor."""
    params = get_model(config).init(gen, config)
    return {"params": params, "opt": init_opt_state(params, opt)}
