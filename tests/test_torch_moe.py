"""The MoE family (granite-moe-3b-a800m, kimi-k2-1t-a32b) in the port,
against the reference, on the CPU.

The same weights (the reference's random init, converted by
``params_from_jax``) and the same numpy inputs go through
``repro.models.moe`` / ``repro.models.transformer`` and their
counterparts in ``repro_torch``: the sort-based positions, the router's
top-k, the MoE layer (its output, aux loss and dropped slots) at each
arch's ``reduced()`` at the published capacity factor 1.25, which drops
slots, and at 4.0, which is drop-free; ``prefill`` and ``decode_step``;
one granite layer at full width; and the serving entry point. fp32 is held
to 1e-5, bf16 to 2e-2 of the largest magnitude compared, as in
tests/test_torch_dense_configs.py. kimi-k2-1t-a32b (about 1 T parameters)
is only ever drawn at ``reduced()``. On the CPU the attention is the naive
version; the flash kernels' checks at hd 64 are in test_torch_kernels.py
and, on the card, in chip_smoke.py.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.serve import parse_args, run_serve
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model

MOE = ("granite-moe-3b-a800m", "kimi-k2-1t-a32b")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _configs(arch, dtype="float32", reduced=True, **kw):
    """The reference's and the port's config, the same numbers."""
    kw = dict(dtype=dtype, param_dtype=dtype, **kw)
    return (jax_get_config(arch, reduced=reduced).replace(**kw),
            get_config(arch, reduced=reduced).replace(**kw))


def _params(jcfg, tcfg, seed=0):
    jp = jtransformer.init(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)


def _layer_moe(jp, tp, i=0):
    """Layer ``i``'s MoE parameters in each package."""
    return (jax.tree_util.tree_map(lambda p: p[i], jp["layers"])["moe"],
            tp["layers"][i]["moe"])


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if tol > 1e-3 else 1.0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * scale)


def _t(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _jax_routing(x, jparams, jcfg):
    """The reference's top-k experts and kept-slot mask for ``x``, by its
    own router and ``_positions_in_expert`` (the steps of
    ``moe_layer``)."""
    T = x.shape[0] * x.shape[1]
    xt = jnp.asarray(x).reshape(T, -1).astype(jnp.float32)
    probs = jax.nn.softmax(xt @ jparams["router"], axis=-1)
    _, top_idx = jax.lax.top_k(probs, jcfg.experts_per_token)
    cap = int(max(1, np.ceil(T * jcfg.experts_per_token / jcfg.num_experts
                             * jcfg.capacity_factor)))
    pos = jmoe._positions_in_expert(top_idx.reshape(-1), jcfg.num_experts)
    return np.asarray(top_idx), np.asarray(pos < cap), cap


def _port_routing(x, tparams, tcfg):
    T = x.shape[0] * x.shape[1]
    _, _, top_idx = tmoe.route(x.reshape(T, -1), tparams["router"],
                               tcfg.experts_per_token)
    pos = tmoe._positions_in_expert(top_idx.reshape(-1), tcfg.num_experts)
    cap = tmoe.capacity(T, tcfg)
    return top_idx.numpy(), (pos < cap).numpy(), cap


# -- the configs -----------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_torch_moe_config_has_the_reference_numbers(arch):
    """Every field the port shares with the reference, the MoE ones
    included, holds the same value at the full config and at reduced()."""
    assert arch in ARCHS
    for reduced in (False, True):
        jcfg = jax_get_config(arch, reduced=reduced)
        tcfg = get_config(arch, reduced=reduced)
        for f in ("name", "family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "d_ff", "vocab_size", "head_dim",
                  "hidden_act", "mlp_gated", "norm", "norm_offset",
                  "rope_theta", "tie_embeddings", "local_window",
                  "is_encoder_decoder", "dtype", "param_dtype",
                  "num_experts", "experts_per_token", "capacity_factor",
                  "router_aux_loss"):
            assert getattr(tcfg, f) == getattr(jcfg, f), (reduced, f)
        assert tcfg.family == "moe" and not tcfg.embed_scale
        assert get_model(tcfg) is ttransformer


def test_torch_granite_full_config_is_the_3b_a800m_model():
    """granite's published widths: hd 64, the first head dim of a ported
    arch that the flash kernels build for it alone."""
    c = get_config("granite-moe-3b-a800m")
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
            c.resolved_head_dim, c.num_experts, c.experts_per_token, c.d_ff,
            c.vocab_size) == (32, 1536, 24, 8, 64, 40, 8, 512, 49155)


# -- positions in expert ----------------------------------------------------------
@pytest.mark.parametrize("E", [1, 4, 40, 384])
def test_torch_positions_in_expert_matches_the_reference(E):
    """Random expert ids (some experts unused at E 384) through both
    packages' ``_positions_in_expert``."""
    ids = np.random.default_rng(E).integers(0, E, (257,), dtype=np.int32)
    got = tmoe._positions_in_expert(torch.from_numpy(ids).long(), E)
    want = jmoe._positions_in_expert(jnp.asarray(ids), E)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the router ---------------------------------------------------------------------
def test_torch_route_breaks_ties_by_lower_index_as_jax_top_k():
    """Exact ties in the router's probabilities go to the lower expert
    index first, as ``jax.lax.top_k`` orders them."""
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.1],
                      [0.25, 0.25, 0.25, 0.25, 0.0],
                      [0.0, 0.2, 0.2, 0.2, 0.4]], np.float32)
    logits = np.log(np.maximum(probs, 1e-30))
    _, want = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), 3)
    eye = torch.eye(5)
    _, _, got = tmoe.route(torch.from_numpy(logits), eye, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [[1, 2, 3], [0, 1, 2], [4, 1, 2]]


# -- the MoE layer ------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.25, 4.0])
def test_torch_moe_layer_matches_jax(arch, dtype, cf):
    """``moe_layer`` at reduced() (4 experts, top 2) on the same
    parameters and input: the top-k experts and the kept slots equal the
    reference's, the output and aux loss agree; at 1.25 slots drop, at 4.0
    (E/k = 2 is enough) none does."""
    jcfg, tcfg = _configs(arch, dtype, capacity_factor=cf)
    jp, tp = _params(jcfg, tcfg, seed=3)
    jm, tm = _layer_moe(jp, tp)
    x = _normal(21, (2, 16, jcfg.d_model))
    jx, tx = jnp.asarray(x, dtype), _t(x, dtype)
    want_idx, want_keep, want_cap = _jax_routing(jx, jm, jcfg)
    got_idx, got_keep, got_cap = _port_routing(tx, tm, tcfg)
    assert got_cap == want_cap
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_array_equal(got_keep, want_keep)
    assert (not got_keep.all()) is (cf == 1.25)
    out, aux = tmoe.moe_layer(tx, tm, tcfg)
    jout, jaux = jmoe.moe_layer(jx, jm, jcfg)
    assert out.dtype == getattr(torch, dtype) and out.shape == x.shape
    assert aux.dtype == torch.float32 and aux.shape == ()
    _close(out, jout, TOL[dtype])
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_moe_overflowing_expert_drops_the_same_slots(dtype):
    """Every token's first choice is expert 0 (a router whose column 0
    dominates), so expert 0 overflows its capacity: the same slots drop in
    both packages, and the dropped tokens keep only their other expert's
    share."""
    jcfg, tcfg = _configs("granite-moe-3b-a800m", dtype)
    jp, tp = _params(jcfg, tcfg, seed=4)
    jm, tm = _layer_moe(jp, tp)
    router = np.asarray(jm["router"]).copy()
    x = np.abs(_normal(22, (2, 16, jcfg.d_model))) + 0.5
    router[:, 0] = 0.2                      # x > 0: expert 0 wins every row
    jm = dict(jm, router=jnp.asarray(router))
    tm = dict(tm, router=torch.from_numpy(router))
    jx, tx = jnp.asarray(x, dtype), _t(x, dtype)
    want_idx, want_keep, cap = _jax_routing(jx, jm, jcfg)
    got_idx, got_keep, _ = _port_routing(tx, tm, tcfg)
    assert (want_idx[:, 0] == 0).all()
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_array_equal(got_keep, want_keep)
    # expert 0 keeps its first `cap` slots by token order, drops the rest
    first = got_keep.reshape(-1, jcfg.experts_per_token)[:, 0]
    assert first.tolist() == [t < cap for t in range(32)]
    _close(tmoe.moe_layer(tx, tm, tcfg)[0], jmoe.moe_layer(jx, jm, jcfg)[0],
           TOL[dtype])


def test_torch_moe_router_capacity_and_gates():
    """tests/test_models.py::test_moe_router_capacity_and_gates on the
    port: stable ranks; granite's reduced() layer 0 on a bf16 input keeps
    its shape, with a finite, non-negative aux loss; the gates of a token
    sum to 1."""
    e = torch.tensor([2, 0, 2, 1, 2, 0], dtype=torch.int32)
    assert tmoe._positions_in_expert(e, 3).tolist() == [0, 0, 1, 0, 2, 1]
    cfg = get_config("granite-moe-3b-a800m", reduced=True)
    params = get_model(cfg).init(torch.Generator().manual_seed(8), cfg)
    x = torch.from_numpy(_normal(9, (2, 16, cfg.d_model))).bfloat16()
    out, aux = tmoe.moe_layer(x, params["layers"][0]["moe"], cfg)
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert math.isfinite(float(aux)) and float(aux) >= 0
    _, gates, _ = tmoe.route(x.reshape(32, -1),
                             params["layers"][0]["moe"]["router"],
                             cfg.experts_per_token)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("arch", MOE)
def test_torch_moe_init_builds_the_reference_tree(arch):
    """The port's ``init`` builds the reference's keys, shapes and types
    (``moe`` in place of ``mlp``, the router in fp32 under bf16
    parameters), and ``params_from_jax`` carries the stacked (L, D, E) and
    (L, E, D, F) leaves over layer by layer."""
    jcfg, tcfg = _configs(arch, "bfloat16")
    jp, conv = _params(jcfg, tcfg, seed=5)
    own = ttransformer.init(torch.Generator().manual_seed(5), tcfg)
    for tree in (own, conv):
        assert len(tree["layers"]) == jcfg.num_layers
        for layer in tree["layers"]:
            assert {g: {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                        for k, v in sub.items()}
                    for g, sub in layer.items()} == {
                g: {k: (v.shape[1:], str(v.dtype)) for k, v in sub.items()}
                for g, sub in jp["layers"].items()}
    assert "mlp" not in own["layers"][0]
    for k, v in jp["layers"]["moe"].items():
        for i, layer in enumerate(conv["layers"]):
            np.testing.assert_array_equal(
                layer["moe"][k].float().numpy(),
                np.asarray(v[i], np.float32))


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_moe_run_layers_sums_the_aux_loss(arch, dtype):
    """``_run_layers`` sums each layer's aux loss in layer order, as the
    reference's scan does (in bf16 the second layer's input, and so its
    router, already carries the two packages' different roundings)."""
    jcfg, tcfg = _configs(arch, dtype)
    jp, tp = _params(jcfg, tcfg, seed=6)
    tok = _tokens(23, (2, 10), jcfg.vocab_size)
    jx, jpos = jtransformer._embed_inputs(jp, {"tokens": jnp.asarray(tok)},
                                          jcfg)
    tx, tpos = ttransformer._embed_inputs(
        tp, {"tokens": torch.from_numpy(tok).long()}, tcfg)
    _, jaux, _ = jtransformer._run_layers(jx, jp, jcfg, jpos, None)
    _, taux, _ = ttransformer._run_layers(tx, tp, tcfg, tpos, None)
    assert taux.dtype == torch.float32 and float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL[dtype])


# -- the model -----------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_moe_prefill_and_decode_match_jax(arch, dtype):
    """``prefill`` logits and cache, then one ``decode_step``, at
    reduced() (2 layers, 4 experts top 2) and the published capacity
    factor 1.25."""
    jcfg, tcfg = _configs(arch, dtype)
    jp, tp = _params(jcfg, tcfg)
    B, S = 2, 11
    tok = _tokens(24, (B, S), jcfg.vocab_size)
    jl, jc = jtransformer.prefill(jp, {"tokens": jnp.asarray(tok)}, jcfg,
                                  max_len=S + 1)
    tl, tc = ttransformer.prefill(tp, {"tokens": torch.from_numpy(tok)},
                                  tcfg, max_len=S + 1)
    tol = TOL[dtype]
    assert tl.shape == (B, 1, jcfg.vocab_size) and tc["pos"] == S
    _close(tl, jl, tol)
    for name in ("k", "v"):
        _close(tc[name], jc[name], tol)
    nxt = _tokens(25, (B, 1), jcfg.vocab_size)
    jl, jc = jtransformer.decode_step(jp, jnp.asarray(nxt), jc, jcfg)
    tl, tc = ttransformer.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
    assert tc["pos"] == int(jc["pos"]) == S + 1
    _close(tl, jl, tol)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("impl", ["flash", "naive"])
def test_torch_moe_prefill_then_decode_matches_full_forward(arch, impl):
    """tests/test_models.py:45-84's MoE cases on the port: greedy prefill +
    decode_step equals the argmax of teacher-forced prefills, drop-free
    (``capacity_factor=4.0``, as the reference's test sets it: which slots
    drop depends on the other tokens of the call)."""
    _, tcfg = _configs(arch, attention_impl=impl, capacity_factor=4.0)
    model = get_model(tcfg)
    params = model.init(torch.Generator().manual_seed(1), tcfg)
    B, S, G = 2, 12, 4
    tokens = torch.from_numpy(_tokens(26, (B, S), tcfg.vocab_size)).long()
    logits, cache = model.prefill(params, {"tokens": tokens}, tcfg,
                                  max_len=S + G)
    serve = [logits[:, -1].argmax(-1)]
    for _ in range(G - 1):
        logits, cache = model.decode_step(params, serve[-1][:, None], cache,
                                          tcfg)
        serve.append(logits[:, -1].argmax(-1))
    full = tokens
    for g in range(G):
        logits2, _ = model.prefill(params, {"tokens": full}, tcfg,
                                   max_len=full.shape[1] + 1)
        nxt = logits2[:, -1].argmax(-1)
        assert torch.equal(nxt, serve[g]), f"step {g}"
        full = torch.cat([full, nxt[:, None]], dim=1)


def test_torch_granite_full_widths_one_layer():
    """granite-moe-3b-a800m's full widths in one layer with a 512-token
    vocabulary, fp32: d_model 1,536, 24/8 heads of hd 64, 40 experts of
    512, top 8, tied embeddings. Prefill logits and cache (32 tokens, 8
    slots an expert: some drop), then one decode step."""
    jcfg, tcfg = _configs("granite-moe-3b-a800m", reduced=False,
                          num_layers=1, vocab_size=512)
    assert (tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads,
            tcfg.resolved_head_dim, tcfg.num_experts,
            tcfg.experts_per_token, tcfg.d_ff) == (1536, 24, 8, 64, 40, 8,
                                                   512)
    jp, tp = _params(jcfg, tcfg, seed=7)
    B, S = 2, 16
    tok = _tokens(27, (B, S), 512)
    jl, jc = jtransformer.prefill(jp, {"tokens": jnp.asarray(tok)}, jcfg,
                                  max_len=S + 1)
    tl, tc = ttransformer.prefill(tp, {"tokens": torch.from_numpy(tok)},
                                  tcfg, max_len=S + 1)
    _close(tl, jl, 1e-5)
    for name in ("k", "v"):
        _close(tc[name], jc[name], 1e-5)
    nxt = _tokens(28, (B, 1), 512)
    jl, _ = jtransformer.decode_step(jp, jnp.asarray(nxt), jc, jcfg)
    tl, _ = ttransformer.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
    _close(tl, jl, 1e-5)


# -- the serving entry point -------------------------------------------------------
def test_torch_serve_granite_matches_the_jax_model():
    """``run_serve --arch granite-moe-3b-a800m --reduced`` (5 requests in
    batches of 4, the last padded) on the reference's weights in fp32 gives
    the greedy tokens of the reference's prefill/decode_step on the same
    prompts, at the published capacity factor, and launches nothing on the
    CPU."""
    arch = "granite-moe-3b-a800m"
    args = parse_args(["--arch", arch, "--reduced", "--requests", "5",
                       "--batch", "4", "--prompt-len", "9", "--gen", "3",
                       "--seed", "7"])
    jcfg, tcfg = _configs(arch)
    jp, tp = _params(jcfg, tcfg, seed=8)
    res = run_serve(args, device="cpu", params=tp, config=tcfg)
    assert set(res["launches"].values()) == {0}
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, jcfg.vocab_size, (args.prompt_len,),
                            dtype=np.int32) for _ in range(args.requests)]
    for lo in range(0, args.requests, args.batch):
        batch = prompts[lo:lo + args.batch]
        batch += [batch[-1]] * (args.batch - len(batch))
        logits, cache = jtransformer.prefill(
            jp, {"tokens": jnp.asarray(np.stack(batch))}, jcfg,
            max_len=args.prompt_len + args.gen)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        outs = [np.asarray(tok)[:, 0]]
        for _ in range(args.gen - 1):
            logits, cache = jtransformer.decode_step(jp, tok, cache, jcfg)
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            outs.append(np.asarray(tok)[:, 0])
        want = np.stack(outs, axis=1)
        for i in range(min(args.batch, args.requests - lo)):
            assert res["results"][lo + i] == want[i].tolist(), lo + i


@pytest.mark.parametrize("arch", MOE)
def test_torch_serve_draws_a_moe_arch_from_the_seed(arch):
    """Without weights, ``run_serve --arch <arch> --reduced`` draws the
    arch's own tree from --seed: two runs agree. kimi-k2-1t-a32b is drawn
    here at reduced() only."""
    args = parse_args(["--arch", arch, "--reduced", "--requests", "2",
                       "--batch", "2", "--prompt-len", "5", "--gen", "2"])
    a = run_serve(args, device="cpu")
    assert a["config"].name == arch and a["config"].num_layers == 2
    assert a["results"] == run_serve(args, device="cpu")["results"]
