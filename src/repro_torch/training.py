"""Train and serve step functions: the model API times the optimizer.

The counterpart of ``repro/training.py``. ``build_train_step`` and
``build_serve_fns`` produce the step functions that the streaming trainer
(``launch/train.py``) and the server (``launch/serve.py``) run.
``shardings_for`` gathers a cell's specs on a mesh (the reference's
GSPMD ``in_shardings``), and ``CellShardings.place`` puts a state, batch
or cache on the mesh by them, as DTensors: the same step functions then
run on the placed trees under ``use_mesh(cell.mesh, cell.rules)``, DTensor
propagating the shardings where XLA's compiler does in the reference.
``lower_cell`` is the reference's dry-run entry: where the reference
lowers a cell's jitted step without allocating, it returns a ``Cell``,
one rank's step with the inputs it is called on, which the dry-run
(``launch/dryrun.py``) runs on fake tensors and a test or the card on
real ones: one program either way. The data-parallel step over a process
group is ``parallel/dp.py``.

The train step takes gradients by autograd through the config's attention
schedule, as the reference's ``jax.grad`` goes through its ``lax.scan``:
``naive``, ``blocked`` and ``triangular`` as asked, and ``flash`` (the
default) as ``blocked``, the reference's default: the reference never
trains through its Pallas kernel, which has no backward pass, nor can the
port through its flash kernel, which refuses inputs that require grad.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs import batch_specs_logical, input_specs
from repro_torch.configs.base import ModelConfig, OptimizerConfig, ShapeConfig
from repro_torch.models.registry import get_model, param_shapes
from repro_torch.optim import adamw_update, init_opt_state, zero1_state_specs
from repro_torch.parallel.sharding import (ShardingRules, is_dtensor,
                                           place_tree, tree_specs_shaped,
                                           use_mesh)
from repro_torch.data.metrics import span
from repro_torch.utils import tree_leaves, tree_map


def rules_for(config: ModelConfig) -> ShardingRules:
    return ShardingRules(overrides=dict(config.sharding_overrides))


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
    state's device (plain tensors, the same on every rank, under a
    mesh). The step is the span ``train_step``, its update the device
    span ``optimizer`` (also the walker's cost scope of that name)."""
    config = train_config(config)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        with span("train_step"):
            loss, metrics, grads = loss_and_grads(state["params"], batch,
                                                  config)
            with span("optimizer", device=True, scope=True):
                params, opt_state, opt_metrics = adamw_update(
                    state["params"], grads, state["opt"], opt)
        metrics = {**metrics, **opt_metrics, "total_loss": loss}
        return ({"params": params, "opt": opt_state},
                {k: _plain(v) for k, v in metrics.items()})

    return train_step


def build_serve_fns(config: ModelConfig) -> tuple[Callable, Callable]:
    """``prefill(params, batch, max_len=None)`` and ``decode_step(params,
    tokens, cache)`` of the config's family, each call a span of its name
    (``prefill``, ``decode``)."""
    model = get_model(config)

    def prefill(params: dict, batch: dict, max_len: int | None = None
                ) -> tuple[torch.Tensor, dict]:
        with span("prefill"):
            return model.prefill(params, batch, config, max_len=max_len)

    def decode_step(params: dict, tokens: torch.Tensor, cache: dict
                    ) -> tuple[torch.Tensor, dict]:
        with span("decode"):
            return model.decode_step(params, tokens, cache, config)

    return prefill, decode_step


def init_state(gen: torch.Generator, config: ModelConfig,
               opt: OptimizerConfig) -> dict:
    """{'params': the family's ``init`` drawn from ``gen`` on its device,
    'opt': ``init_opt_state``}; every leaf its own tensor."""
    params = get_model(config).init(gen, config)
    return {"params": params, "opt": init_opt_state(params, opt)}


def _plain(x: Any) -> Any:
    """A DTensor metric as the full tensor, the same on every rank."""
    return x.full_tensor() if is_dtensor(x) else x


# -- sharding assembly -------------------------------------------------------------
@dataclass
class CellShardings:
    """Every spec of one (arch x shape x mesh) cell
    (``repro/training.py:80``): the parameters', and the train state's,
    the batch's and the cache's where the cell's kind has them."""
    mesh: Any
    rules: ShardingRules
    param_specs: Any
    state_specs: Any | None = None          # train
    batch_specs: Any | None = None
    cache_specs: Any | None = None          # prefill and decode

    def place(self, tree: Any, specs: Any) -> Any:
        """``tree`` on the cell's ``DeviceMesh`` by ``specs`` (one of the
        cell's spec trees): each tensor a DTensor of this rank's block,
        the same full tree being on every rank; the counterpart of
        ``jit``'s ``in_shardings``."""
        return place_tree(tree, specs, self.mesh)


def shardings_for(config: ModelConfig, shape: ShapeConfig, mesh: Any,
                  opt: OptimizerConfig | None = None) -> CellShardings:
    """The cell's specs on ``mesh`` (a ``DeviceMesh`` or an abstract
    mesh), each with the axes that do not divide its leaf dropped
    (``repro/training.py:95``): train the state's (the parameters' and
    ``zero1_state_specs``) and the batch's; prefill the batch's and the
    cache's for ``seq_len`` positions; decode the tokens' and the
    cache's."""
    model = get_model(config)
    rules = rules_for(config)
    shapes = param_shapes(config)
    pspecs = tree_specs_shaped(model.param_specs(config), shapes, mesh,
                               rules)
    cell = CellShardings(mesh=mesh, rules=rules, param_specs=pspecs)
    logical = batch_specs_logical(config, shape)
    inputs = input_specs(config, shape)
    if shape.kind == "train":
        cell.state_specs = {
            "params": pspecs,
            "opt": zero1_state_specs(pspecs, shapes, mesh,
                                     opt or OptimizerConfig())}
        cell.batch_specs = tree_specs_shaped(logical["batch"],
                                             inputs["batch"], mesh, rules)
    elif shape.kind == "prefill":
        cache = model.init_cache(config, shape.global_batch, shape.seq_len,
                                 torch.device("meta"))
        cell.batch_specs = tree_specs_shaped(logical["batch"],
                                             inputs["batch"], mesh, rules)
        cell.cache_specs = tree_specs_shaped(model.cache_specs(config),
                                             cache, mesh, rules)
    else:
        cell.batch_specs = tree_specs_shaped(logical["tokens"],
                                             inputs["tokens"], mesh, rules)
        cell.cache_specs = tree_specs_shaped(model.cache_specs(config),
                                             inputs["cache"], mesh, rules)
    return cell


# -- lowering (dry-run entry points) -----------------------------------------------
@dataclass
class Cell:
    """One rank's step of an (arch x shape x mesh) cell. ``inputs()`` draws
    the step's arguments from seed 0 and places them by the cell's specs,
    each sharded leaf this rank's own block in a storage of its own (under
    ``FakeTensorMode`` fake tensors, nothing allocated);
    ``cell(*args)`` runs the step under the cell's mesh and rules.
    ``kind`` is the shape's: train -> ``train_step(state, batch)``,
    prefill -> ``prefill(params, batch)``, decode -> ``decode_step(params,
    tokens, cache)``."""
    kind: str
    step: Callable
    inputs: Callable[[], tuple]
    mesh: Any = None
    rules: ShardingRules | None = None

    def __call__(self, *args: Any) -> Any:
        if self.mesh is None:
            return self.step(*args)
        with use_mesh(self.mesh, self.rules):
            return self.step(*args)


def _own_blocks(tree: Any) -> Any:
    """``tree`` with each DTensor leaf whose local block is a view into a
    larger tensor rebuilt on a copy of its block, so that a rank holds
    (and a memory count sees) only its own bytes."""
    from torch.distributed.tensor import DTensor

    def own(x: Any) -> Any:
        if not is_dtensor(x):
            return x
        local = x.to_local()
        if local.untyped_storage().nbytes() <= local.numel() * \
                local.element_size():
            return x
        return DTensor.from_local(local.clone(), x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())
    return tree_map(own, tree)


def _cell_device(mesh: Any, device: Any) -> torch.device:
    if device is not None:
        return torch.device(device)
    kind = getattr(mesh, "device_type", "cpu")
    return torch.device(kind, 0) if kind == "cuda" else torch.device(kind)


def _draw_batch(gen: torch.Generator, config: ModelConfig, specs: dict,
                device: torch.device) -> dict:
    """``input_specs``' batch drawn from ``gen``: tokens uniform over the
    vocabulary, image embeddings and frames standard normal."""
    out = {}
    for name, meta in specs.items():
        if meta.dtype == torch.int64:
            out[name] = torch.randint(0, config.vocab_size, tuple(meta.shape),
                                      generator=gen, device=device)
        else:
            out[name] = torch.randn(tuple(meta.shape), generator=gen,
                                    device=device).to(meta.dtype)
    return out


def lower_cell(config: ModelConfig, shape: ShapeConfig, mesh: Any,
               opt: OptimizerConfig | None = None, *, device: Any = None
               ) -> tuple[Cell, str]:
    """The cell's step at full scale on ``mesh``
    (``repro/training.py:131``): returns (cell, kind). train ->
    ``build_train_step`` on ``init_state`` and the batch, placed by
    ``shardings_for``'s state and batch specs; prefill -> ``build_serve_fns``'
    prefill on the parameters and the batch; decode -> its decode step on
    the parameters, one token a row and a cache of ``seq_len`` positions
    whose last slot the step writes (the step reads every slot whatever
    the position, as the reference's does). ``device`` defaults to the
    mesh's device type."""
    opt = opt or OptimizerConfig()
    model = get_model(config)
    cell = shardings_for(config, shape, mesh, opt)
    specs = input_specs(config, shape)
    dev = _cell_device(mesh, device)
    B, S = shape.global_batch, shape.seq_len

    def generator() -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(0)

    if shape.kind == "train":
        step = build_train_step(config, opt)

        def draw() -> tuple:
            gen = generator()
            state = cell.place(init_state(gen, config, opt),
                               cell.state_specs)
            batch = cell.place(_draw_batch(gen, config, specs["batch"], dev),
                               cell.batch_specs)
            return _own_blocks(state), _own_blocks(batch)
    elif shape.kind == "prefill":
        step = build_serve_fns(config)[0]

        def draw() -> tuple:
            gen = generator()
            params = cell.place(model.init(gen, config), cell.param_specs)
            batch = cell.place(_draw_batch(gen, config, specs["batch"], dev),
                               cell.batch_specs)
            return _own_blocks(params), _own_blocks(batch)
    else:
        step = build_serve_fns(config)[1]

        def draw() -> tuple:
            gen = generator()
            params = cell.place(model.init(gen, config), cell.param_specs)
            tokens = cell.place(torch.randint(
                0, config.vocab_size, (B, 1), generator=gen, device=dev),
                cell.batch_specs)
            cache = model.init_cache(config, B, S, dev)
            if "pos" in cache:
                cache["pos"] = S - 1
            cache = cell.place(cache, cell.cache_specs)
            return _own_blocks(params), _own_blocks(tokens), _own_blocks(cache)
    return Cell(shape.kind, step, draw, cell.mesh, cell.rules), shape.kind
