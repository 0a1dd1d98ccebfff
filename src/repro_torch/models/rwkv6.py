"""RWKV-6 "Finch", the ssm family: an attention-free LM with data-dependent
decay, init and the serve path.

The counterpart of ``repro/models/rwkv6.py``. The recurrence per head
(K = V = head_dim):

    y_t = r_t^T S_{t-1}  +  (r_t · (u ⊙ k_t)) v_t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(-exp(w0 + LoRA(x_t)))

in three evaluations of the same math, each held to the others and to its
JAX twin in the tests:

* ``_wkv_chunked`` — the prefill: chunks of ``rwkv_chunk`` tokens, the
  cumulative log-decay within a chunk, the pairwise intra-chunk terms as
  log-space differences (always <= 0, so exp never overflows, even at
  near-zero decay), the inter-chunk terms through the state. The reference
  runs the whole chunk step under ``jax.lax.scan``; here every term that
  does not read the state (the intra-chunk output, each chunk's own
  contribution to the state, the decayed queries) is computed for all
  chunks at once, and only the state's carry from chunk to chunk is a loop,
  T / chunk steps of one multiply-add a layer. The same products, summed
  in another order.
* ``_wkv_recurrent`` — token by token (the oracle);
* ``_wkv_step`` — one decode token.

The WKV runs in fp32 on PyTorch operations on the card: the reference has
no Pallas kernel for it, so the port writes none (a fused WKV kernel would
be new work, for a later ``perf_opt``). fp32 products stay off TF32, as the
reference's fp32 matmuls do. The decode state is constant-size: per layer
the fp32 WKV state ``S`` (B, H, K, K) and the last normed inputs of the
time and channel mixes (``tshift``, ``cshift``), stacked on L as the
reference's and updated in place; ``init_cache`` ignores ``max_len``, as
the reference's does. The layers are a list of per-layer dicts, as in the
port's transformer. ``loss_and_metrics`` is the training loss (chunked
from a zero state; the chunked WKV's coefficients out of place while
autograd records). ``param_specs`` and ``cache_specs`` give the trees'
logical axes; under a mesh the WKV runs on each rank's own (batch, heads)
block (``_wkv_local``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.parallel.sharding import (is_dtensor, like,
                                           logical_constraint, redistribute,
                                           summed, zeros_logical)


# -- init ------------------------------------------------------------------------
def _init_block(gen: torch.Generator, config: ModelConfig,
                dtype: torch.dtype) -> dict:
    """The reference's block: lerp factors 0.5, its standard deviations,
    the decay bias ``w0`` = linspace(-6, -0.5) and the bonus ``u`` in fp32."""
    d, f, dl = config.d_model, config.d_ff, config.decay_lora
    dev = gen.device
    std = 1.0 / math.sqrt(d)
    std_o = std / math.sqrt(2.0 * config.num_layers)
    return {
        # time mixing
        "mu": torch.full((5, d), 0.5, dtype=dtype, device=dev),  # r,k,v,w,g
        "w_r": L.normal_init(gen, (d, d), std, dtype),
        "w_k": L.normal_init(gen, (d, d), std, dtype),
        "w_v": L.normal_init(gen, (d, d), std, dtype),
        "w_g": L.normal_init(gen, (d, d), std, dtype),
        "w_o": L.normal_init(gen, (d, d), std_o, dtype),
        "w0": torch.from_numpy(
            np.linspace(-6.0, -0.5, d).astype(np.float32)).to(dev),
        "w_lora_a": L.normal_init(gen, (d, dl), std, dtype),
        "w_lora_b": L.normal_init(gen, (dl, d), 1e-2, dtype),
        "u": L.normal_init(gen, (d,), 0.5, torch.float32),
        "ln_x_scale": torch.ones(d, dtype=dtype, device=dev),
        "ln_x_bias": torch.zeros(d, dtype=dtype, device=dev),
        # channel mixing
        "cmu": torch.full((2, d), 0.5, dtype=dtype, device=dev),  # k, r
        "w_ck": L.normal_init(gen, (d, f), std, dtype),
        "w_cv": L.normal_init(gen, (f, d), std_o, dtype),
        "w_cr": L.normal_init(gen, (d, d), std, dtype),
        "norm1": L.init_norm(config, dtype, dev),
        "norm2": L.init_norm(config, dtype, dev),
    }


def init(gen: torch.Generator, config: ModelConfig) -> dict:
    """Random parameters in ``config.param_dtype`` (``w0`` and ``u`` fp32)
    drawn from ``gen`` on its device: {'embed': {...}, 'layers':
    [per-layer dicts], 'final_norm': {...}}, the reference's tree with the
    layers as a list."""
    dtype = config.parameter_dtype
    embed = L.init_embedding(gen, config, dtype)
    layers = [_init_block(gen, config, dtype)
              for _ in range(config.num_layers)]
    return {"embed": embed, "layers": layers,
            "final_norm": L.init_norm(config, dtype, gen.device)}


def _block_specs(config: ModelConfig) -> dict:
    """One layer's logical axes (``repro/models/rwkv6.py:71``)."""
    return {
        "mu": ("null", "embed"), "w_r": ("embed_fsdp", "heads"),
        "w_k": ("embed_fsdp", "heads"), "w_v": ("embed_fsdp", "heads"),
        "w_g": ("embed_fsdp", "heads"), "w_o": ("heads", "embed_fsdp"),
        "w0": ("heads",), "w_lora_a": ("embed_fsdp", "null"),
        "w_lora_b": ("null", "heads"), "u": ("heads",),
        "ln_x_scale": ("embed",), "ln_x_bias": ("embed",),
        "cmu": ("null", "embed"), "w_ck": ("embed_fsdp", "ff"),
        "w_cv": ("ff", "embed_fsdp"), "w_cr": ("embed_fsdp", "null"),
        "norm1": L.norm_specs(config), "norm2": L.norm_specs(config),
    }


def param_specs(config: ModelConfig) -> dict:
    """Logical axes of ``init``'s tree (``repro/models/rwkv6.py:97``),
    each layer's without the reference's leading "layers" axis."""
    return {"embed": L.embedding_specs(config),
            "layers": [_block_specs(config)
                       for _ in range(config.num_layers)],
            "final_norm": L.norm_specs(config)}


# -- WKV ---------------------------------------------------------------------------
def _wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                 chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, logw: (B, T, H, K) fp32; u: (H, K); state: (B, H, K, V).
    Returns (y (B, T, H, V), the final state)."""
    B, T, H, K = r.shape
    C = min(chunk, T)
    n = -(-T // C)
    pad = n * C - T
    if pad:
        # padded steps have k = v = 0 and log w = 0 (w = 1), so they leave
        # the state as it is
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
    rb, kb, vb, lwb = (t.reshape(B, n, C, H, K) for t in (r, k, v, logw))

    la = torch.cumsum(lwb, dim=2)                   # inclusive, (B,n,C,H,K)
    la_prev = la - lwb                              # exclusive
    # intra-chunk pairwise log-space differences, <= 0 below the diagonal
    # (s < t); on and above it they may be large, so they are masked to
    # -inf before exp (exp of them never overflows, and no inf meets a
    # zero in the backward pass): coef is exp(diff) below the diagonal, u
    # on it and 0 above. Under grad it is built out of place (autograd
    # keeps exp's output); otherwise in place, to keep one
    # (B, n, C, C, H, K) fp32 tensor alive a layer
    diff = la_prev[:, :, :, None] - la[:, :, None, :]
    upper = torch.ones(C, C, dtype=torch.bool, device=r.device).triu()
    if torch.is_grad_enabled():
        coef = torch.exp(diff.masked_fill(upper[:, :, None, None],
                                          -math.inf))
        eye = torch.eye(C, dtype=coef.dtype, device=r.device)
        coef = coef + eye[:, :, None, None] * u
        scores = (coef * rb[:, :, :, None] * kb[:, :, None]).sum(-1)
    else:
        coef = diff.masked_fill_(upper[:, :, None, None], -math.inf).exp_()
        coef.diagonal(dim1=2, dim2=3).copy_(u[..., None].expand(B, n, H, K,
                                                                 C))
        scores = coef.mul_(rb[:, :, :, None]).mul_(kb[:, :, None]).sum(-1)
    y = torch.einsum("bntsh,bnshv->bnthv", scores, vb)      # intra-chunk
    # each chunk's own contribution to the state at its end, and the
    # decay of the state across the chunk
    g = torch.exp(la[:, :, -1:] - la)                      # <= 1
    contrib = torch.einsum("bnshk,bnshv->bnhkv", kb * g, vb)
    decay = torch.exp(la[:, :, -1])[..., None]             # (B,n,H,K,1)
    # the carry: the state entering each chunk
    entering = []
    for c in range(n):
        entering.append(state)
        state = decay[:, c] * state + contrib[:, c]
    S_in = torch.stack(entering, dim=1)                    # (B,n,H,K,V)
    # inter-chunk: y += (r ⊙ e^{la_prev}) S
    y = torch.einsum("bnthk,bnhkv->bnthv", rb * torch.exp(la_prev),
                     S_in) + y
    return y.reshape(B, n * C, H, K)[:, :T], state


def _wkv_recurrent(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact sequential recurrence, token by token (the oracle)."""
    ys = []
    for t in range(r.shape[1]):
        y, state = _wkv_step(r[:, t], k[:, t], v[:, t], logw[:, t], u, state)
        ys.append(y)
    return torch.stack(ys, dim=1), state


def _wkv_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One token: r, k, v, logw (B, H, K) -> (y (B, H, V), the state)."""
    y = torch.einsum("bhk,bhkv->bhv", r, state) + \
        torch.einsum("bhk,hk,bhk,bhv->bhv", r, u, k, v)
    state = torch.exp(logw)[..., None] * state + \
        k[..., None] * v[..., None, :]
    return y, state


# -- block -------------------------------------------------------------------------
def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """xs[t] = x[t-1]; xs[0] = prev (carried across calls)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _wkv(mode: str, r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
         chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The WKV by ``mode``: "chunked", "recurrent" or "decode" (T == 1);
    returns (y (B, T, H, V), the new state)."""
    if mode == "chunked":
        return _wkv_chunked(r, k, v, logw, u, state, chunk)
    if mode == "recurrent":
        return _wkv_recurrent(r, k, v, logw, u, state)
    if mode == "decode":
        y, state = _wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u,
                             state)
        return y[:, None], state
    raise ValueError(f"unknown WKV mode {mode!r}")


def _wkv_local(mode: str, r, k, v, logw, u, state, chunk: int):
    """``_wkv`` of DTensors on each rank's own (batch, heads) block, which
    holds every term of its recurrence: r, k, v and log w take r's
    placements (the batch and the heads sharded at most), u its heads',
    the state its batch's and heads'; y keeps r's placements. DTensor would
    otherwise meet the batch and the heads merged into one sharded
    dimension in the WKV's products."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, places = r.device_mesh, summed(r.placements)
    if any(not (isinstance(p, Replicate) or (isinstance(p, Shard)
                                             and p.dim in (0, 2)))
           for p in places):
        raise ValueError(f"the WKV on DTensors shards only the batch and "
                         f"the heads; r is placed {places}")

    def moved(dims: dict) -> tuple:
        return tuple(Shard(dims[p.dim]) if isinstance(p, Shard)
                     and p.dim in dims else Replicate() for p in places)

    u_places, s_places = moved({2: 0}), moved({0: 0, 2: 1})
    local = [redistribute(t, mesh, places).to_local() for t in (r, k, v,
                                                                  logw)]
    # each rank's rows give u's gradient a part of its sum over the batch
    u_grad = tuple(Partial() if isinstance(p, Shard) and p.dim == 0 else q
                   for p, q in zip(places, u_places))
    u = redistribute(u, mesh, u_places).to_local(grad_placements=u_grad)
    y, new = _wkv(mode, *local, u,
                  redistribute(state, mesh, s_places).to_local(), chunk)
    return (DTensor.from_local(y, mesh, places, run_check=False),
            DTensor.from_local(new, mesh, s_places, run_check=False))


def _time_mix(x: torch.Tensor, xs: torch.Tensor, p: dict,
              config: ModelConfig, state: torch.Tensor, mode: str
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The time mix: lerped inputs, r/k/v/g projections, the decay LoRA
    tanh(x_w A) B in the activation dtype and log w = -exp(w0 + LoRA) in
    fp32, the WKV (``mode`` "chunked", "recurrent" or "decode"), a per-head
    group norm in fp32 (eps 64e-5), the SiLU gate and the out projection.
    Returns (out, the new state)."""
    B, T, D = x.shape
    H, K = config.num_heads, config.resolved_head_dim
    dtype = x.dtype
    mu = p["mu"].to(dtype)
    xr, xk, xv, xw, xg = (x + (xs - x) * mu[i] for i in range(5))

    def heads(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (t @ w.to(dtype)).reshape(B, T, H, K).float()

    r, k, v = heads(xr, p["w_r"]), heads(xk, p["w_k"]), heads(xv, p["w_v"])
    g = xg @ p["w_g"].to(dtype)
    # data-dependent decay (Finch): log w = -exp(w0 + tanh(x A) B) <= 0
    lora = torch.tanh(xw @ p["w_lora_a"].to(dtype)) @ p["w_lora_b"].to(dtype)
    logw = -torch.exp(p["w0"].float() + lora.float()).reshape(B, T, H, K)
    r = logical_constraint(r, "batch", "seq", "heads", "head_dim")
    k = logical_constraint(k, "batch", "seq", "heads", "head_dim")
    u = p["u"].float().reshape(H, K)
    wkv = _wkv_local if is_dtensor(r) else _wkv
    y, state = wkv(mode, r, k, v, logw, u, state, config.rwkv_chunk)
    # per-head group norm, gate, project out
    mean = torch.mean(y, dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, correction=0)
    yn = ((y - mean) * torch.rsqrt(var + 64e-5)).reshape(B, T, D).to(dtype)
    yn = yn * p["ln_x_scale"].to(dtype) + p["ln_x_bias"].to(dtype)
    return L.seq_whole((yn * F.silu(g)) @ p["w_o"].to(dtype)), state


def _channel_mix(x: torch.Tensor, xs: torch.Tensor, p: dict,
                 config: ModelConfig) -> torch.Tensor:
    """Squared ReLU of the key projection, gated by a sigmoid receptance."""
    dtype = x.dtype
    cmu = p["cmu"].to(dtype)
    xk = x + (xs - x) * cmu[0]
    xr = x + (xs - x) * cmu[1]
    kk = torch.square(torch.relu(xk @ p["w_ck"].to(dtype)))
    kk = logical_constraint(kk, "batch", "seq", "ff")
    return L.seq_whole(torch.sigmoid(xr @ p["w_cr"].to(dtype))
                       * (kk @ p["w_cv"].to(dtype)))


def _block(x: torch.Tensor, p: dict, config: ModelConfig, state: dict,
           mode: str) -> tuple[torch.Tensor, dict]:
    """One layer: time mix and channel mix, each after its LayerNorm and
    token shift. ``state``: that layer's 'S', 'tshift', 'cshift'; returns
    (x, the layer's new state)."""
    h = L.seq_whole(L.apply_norm(x, p["norm1"], config))
    xs = _token_shift(h, state["tshift"])
    new_tshift = h[:, -1]
    a, S = _time_mix(h, xs, p, config, state["S"], mode)
    x = logical_constraint(x + a, "batch", "act_seq", "embed")
    h = L.seq_whole(L.apply_norm(x, p["norm2"], config))
    xs = _token_shift(h, state["cshift"])
    new_cshift = h[:, -1]
    x = x + _channel_mix(h, xs, p, config)
    x = logical_constraint(x, "batch", "act_seq", "embed")
    return x, {"S": S, "tshift": new_tshift, "cshift": new_cshift}


# -- model -------------------------------------------------------------------------
def init_state(config: ModelConfig, batch: int,
               device: torch.device) -> dict:
    """'S': (L, batch, H, K, K) fp32; 'tshift', 'cshift': (L, batch, D) in
    the activation dtype; zeros; 'pos': 0."""
    H, K = config.num_heads, config.resolved_head_dim
    n, D = config.num_layers, config.d_model
    dtype = config.activation_dtype
    return {"S": torch.zeros((n, batch, H, K, K), dtype=torch.float32,
                             device=device),
            "tshift": torch.zeros((n, batch, D), dtype=dtype, device=device),
            "cshift": torch.zeros((n, batch, D), dtype=dtype, device=device),
            "pos": 0}


def cache_specs(config: ModelConfig) -> dict:
    """Logical axes of ``init_state``'s tree, stacked on L as the
    reference's (``repro/models/rwkv6.py:255``)."""
    return {"S": ("layers", "batch", "heads", "null", "null"),
            "tshift": ("layers", "batch", "embed"),
            "cshift": ("layers", "batch", "embed"), "pos": ()}


def init_cache(config: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    """``init_state``: the state is constant-size, so ``max_len`` is not
    read."""
    return init_state(config, batch, device)


def _run(params: dict, tokens: torch.Tensor, config: ModelConfig,
         state: dict, mode: str) -> tuple[torch.Tensor, dict]:
    """The final-normed hidden states (B, S, D), and the state S tokens on:
    its tensors written in place, or, while autograd records, a new state
    stacked from the layers' (each layer then under activation
    checkpointing when ``remat`` is not ``"none"``, as the reference
    checkpoints its scan body)."""
    x = logical_constraint(L.embed_tokens(tokens, params["embed"], config),
                           "batch", "act_seq", "embed")
    names = ("S", "tshift", "cshift")
    if torch.is_grad_enabled():
        def block(x: torch.Tensor, p: dict, layer_state: dict):
            return _block(x, p, config, layer_state, mode)

        block = L.remat(block, L.layer_policy(config))
        new = {name: [] for name in names}
        for i, p in enumerate(params["layers"]):
            x, ns = block(x, p, {name: state[name][i] for name in names})
            for name in names:
                new[name].append(ns[name])
        state = {**state, **{name: torch.stack(new[name])
                             for name in names}}
    else:
        for i, p in enumerate(params["layers"]):
            x, ns = _block(x, p, config, {name: state[name][i]
                                          for name in names}, mode)
            for name, t in ns.items():
                state[name][i].copy_(like(t, state[name][i]))
    x = L.apply_norm(x, params["final_norm"], config)
    return x, {**state, "pos": state["pos"] + tokens.shape[1]}


def prefill(params: dict, batch: dict, config: ModelConfig,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Run the prompt ``batch['tokens']`` (B, S) through the chunked WKV
    from a zero state; returns last-token logits (B, 1, V) and the state.
    ``max_len`` is not read."""
    tokens = batch["tokens"]
    state = zeros_logical(lambda dev: init_state(config, tokens.shape[0],
                                                 dev),
                          cache_specs(config), tokens.device)
    x, state = _run(params, tokens, config, state, mode="chunked")
    return L.lm_logits(x[:, -1:], params["embed"], config), state


def decode_step(params: dict, tokens: torch.Tensor, cache: dict,
                config: ModelConfig) -> tuple[torch.Tensor, dict]:
    """tokens: (B, 1) -> (logits (B, 1, V), the state one token on)."""
    x, cache = _run(params, tokens, config, cache, mode="decode")
    return L.lm_logits(x, params["embed"], config), cache


def loss_and_metrics(params: dict, batch: dict, config: ModelConfig
                     ) -> tuple[torch.Tensor, dict]:
    """The training loss: the next-token cross-entropy of the tokens run
    through the chunked WKV from a zero state (``transformer._chunked_ce``);
    the aux loss an fp32 zero."""
    tokens = batch["tokens"]
    state = init_state(config, tokens.shape[0], tokens.device)
    x, _ = _run(params, tokens, config, state, mode="chunked")
    pred, targets, mask = transformer.next_token_targets(x, batch)
    loss = transformer._chunked_ce(pred, params, config, targets, mask)
    return loss, {"loss": loss,
                  "aux_loss": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}
