"""The port's dense model stack against the reference, on the CPU.

The same weights (the reference's random init, converted by
``repro_torch.models.convert.params_from_jax``) and the same numpy inputs
go through ``repro.models`` and ``repro_torch.models``: the layers, the
attention layer with and without its cache, ``prefill`` and
``decode_step`` at internlm2-1.8b's ``reduced()`` size and, in one layer,
at its full widths. fp32 is held to 1e-5 (the reductions' round-off), bf16
to 2e-2 (tests/test_kernels.py's bf16 tolerance) of the largest magnitude
compared: the logits reach 3-4, where a bf16 step is 0.016, and the two
frameworks round activations at different places (XLA keeps a fused
elementwise chain in fp32), which leaves them up to 0.037 apart at
reduced() (3 seeds, 5 steps each). On the CPU the attention
is the naive version; the kernel's own checks are in test_torch_kernels.py
and, on the card, in chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch.configs import WAITING, get_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from repro_torch.models.registry import get_model

ARCH = "internlm2-1.8b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _configs(dtype="float32", **kw):
    """The reference's and the port's config, the same numbers."""
    kw = dict(dtype=dtype, param_dtype=dtype, **kw)
    return (jax_get_config(ARCH, reduced=True).replace(**kw),
            get_config(ARCH, reduced=True).replace(**kw))


def _params(jcfg, tcfg, seed=0):
    jp = jtransformer.init(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)


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


# -- layers ----------------------------------------------------------------------
@pytest.mark.parametrize("width", [64, 2048])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_rmsnorm(width, dtype):
    """At reduced()'s and the full model's width."""
    x, w = _normal(1, (3, 5, width)), _normal(2, (width,))
    got = tlayers.rmsnorm(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(w))
    want = jlayers.rmsnorm(jnp.asarray(x, dtype), jnp.asarray(w))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("head_dim", [16, 128])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_torch_apply_rope(theta, head_dim):
    """At reduced()'s and the full model's head width."""
    x = _normal(6, (2, 7, 4, head_dim))
    pos = np.tile(np.arange(3, 10), (2, 1))
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_mlp(dtype):
    """The SwiGLU MLP, weights and input in ``dtype``."""
    jcfg, tcfg = _configs(dtype)
    jp, _ = jlayers.init_mlp(jax.random.PRNGKey(7), jcfg, jnp.dtype(dtype))
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    x = _normal(8, (2, 5, jcfg.d_model))
    got = tlayers.mlp(torch.from_numpy(x).to(getattr(torch, dtype)), tp, tcfg)
    want = jlayers.mlp(jnp.asarray(x, dtype), jp, jcfg)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_embed_tokens(dtype):
    """The fp32 table rounded to the activation dtype, as the reference
    rounds it."""
    jcfg, tcfg = _configs(dtype)
    jp, _ = jlayers.init_embedding(jax.random.PRNGKey(9), jcfg, jnp.float32)
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    tok = _tokens(10, (2, 6), jcfg.vocab_size)
    got = tlayers.embed_tokens(torch.from_numpy(tok).long(), tp, tcfg)
    want = jlayers.embed_tokens(jnp.asarray(tok), jp, jcfg)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_lm_logits(dtype):
    """The untied head, input in ``dtype``."""
    jcfg, tcfg = _configs(dtype)
    jp, _ = jlayers.init_embedding(jax.random.PRNGKey(11), jcfg, jnp.float32)
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    x = _normal(12, (2, 3, jcfg.d_model)) * 4
    got = tlayers.lm_logits(torch.from_numpy(x).to(getattr(torch, dtype)),
                            tp, tcfg)
    want = jlayers.lm_logits(jnp.asarray(x, dtype), jp, jcfg)
    _close(got, want, TOL[dtype])


# -- attention -------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["no cache", "prefill", "decode"])
def test_torch_attention_layer(mode):
    """The layer at reduced() in fp32 (GQA 4/2 heads): without a cache, as
    the prefill branch that fills one, and as a decode step against it."""
    jcfg, tcfg = _configs()
    jp, _ = jattn.init_attention(jax.random.PRNGKey(13), jcfg, jnp.float32)
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    B, S, Smax = 2, 9, 12
    x = _normal(14, (B, S, jcfg.d_model))
    pos = np.tile(np.arange(S), (B, 1))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    if mode == "no cache":
        want, _ = jattn.attention_layer(jx, jp, jcfg, jpos)
        got, cache = tattn.attention_layer(tx, tp, tcfg, tpos)
        assert cache is None
        _close(got, want, 1e-5)
        return
    jc = jattn.init_cache(jcfg, B, Smax)
    tc = tattn.init_cache(tcfg, B, Smax, torch.device("cpu"))
    want, jc = jattn.attention_layer(jx, jp, jcfg, jpos, cache=jc)
    got, tc = tattn.attention_layer(tx, tp, tcfg, tpos, cache=tc)
    if mode == "decode":
        x1 = _normal(15, (B, 1, jcfg.d_model))
        p1 = np.full((B, 1), S)
        want, jc = jattn.attention_layer(jnp.asarray(x1), jp, jcfg,
                                         jnp.asarray(p1), cache=jc)
        got, tc = tattn.attention_layer(torch.from_numpy(x1), tp, tcfg,
                                        torch.from_numpy(p1), cache=tc)
    _close(got, want, 1e-5)
    assert tc["pos"] == int(jc["pos"])
    for name in ("k", "v"):
        _close(tc[name], jc[name], 1e-5)


# -- the serve path ----------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_prefill_and_decode_match_jax(dtype):
    """``prefill`` logits and cache, then 4 ``decode_step``s fed the same
    tokens, at reduced() (2 layers, GQA 4/2 heads)."""
    jcfg, tcfg = _configs(dtype)
    jp, tp = _params(jcfg, tcfg)
    B, S, G = 2, 11, 4
    tok = _tokens(16, (B, S), jcfg.vocab_size)
    jl, jc = jtransformer.prefill(jp, {"tokens": jnp.asarray(tok)}, jcfg,
                                  max_len=S + G)
    tl, tc = ttransformer.prefill(tp, {"tokens": torch.from_numpy(tok)},
                                  tcfg, max_len=S + G)
    tol = TOL[dtype]
    assert tl.shape == (B, 1, jcfg.vocab_size)
    assert tc["k"].shape == (2, B, S + G, 2, 16) and tc["pos"] == S
    _close(tl, jl, tol)
    for name in ("k", "v"):
        _close(tc[name], jc[name], tol)
    steps = _tokens(17, (G, B, 1), jcfg.vocab_size)
    for g in range(G):
        jl, jc = jtransformer.decode_step(jp, jnp.asarray(steps[g]), jc, jcfg)
        tl, tc = ttransformer.decode_step(tp, torch.from_numpy(steps[g]),
                                          tc, tcfg)
        assert tc["pos"] == int(jc["pos"]) == S + g + 1
        _close(tl, jl, tol)
    for name in ("k", "v"):
        _close(tc[name], jc[name], tol)


@pytest.mark.parametrize("impl", ["flash", "naive"])
def test_torch_prefill_then_decode_matches_full_forward(impl):
    """tests/test_models.py:45-84 on the port: greedy prefill + decode_step
    equals the argmax of teacher-forced prefills."""
    _, tcfg = _configs(attention_impl=impl)
    model = get_model(tcfg)
    params = model.init(torch.Generator().manual_seed(1), tcfg)
    B, S, G = 2, 12, 4
    tokens = torch.from_numpy(_tokens(18, (B, S), tcfg.vocab_size)).long()
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_params_from_jax_round_trip(dtype):
    """Every leaf arrives with its dtype and exact value, layer i of the
    port holding slice i of the reference's stacked leaf."""
    jcfg, tcfg = _configs(dtype)
    jp, tp = _params(jcfg, tcfg, seed=3)
    assert len(tp["layers"]) == jcfg.num_layers
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    for path, leaf in flat:
        keys = [p.key for p in path]
        if keys[0] == "layers":
            for i, layer in enumerate(tp["layers"]):
                t = layer[keys[1]][keys[2]]
                assert t.dtype == getattr(torch, dtype)
                np.testing.assert_array_equal(
                    t.float().numpy(), np.asarray(leaf[i], np.float32))
        else:
            t = tp[keys[0]][keys[1]]
            assert t.dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(leaf, np.float32))


def test_torch_full_widths_one_layer():
    """internlm2-1.8b's full widths (d 2048, 16 query and 8 KV heads of
    128, d_ff 8192) in one layer with a 512-token vocabulary, fp32: the
    head layout and GQA grouping that reduced()'s 16-wide heads cannot
    show. Prefill logits and cache, then one decode step."""
    kw = dict(dtype="float32", param_dtype="float32", num_layers=1,
              vocab_size=512)
    jcfg = jax_get_config(ARCH).replace(**kw)
    tcfg = get_config(ARCH).replace(**kw)
    assert (tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads,
            tcfg.resolved_head_dim, tcfg.d_ff) == (2048, 16, 8, 128, 8192)
    jp, tp = _params(jcfg, tcfg, seed=4)
    B, S = 2, 16
    tok = _tokens(19, (B, S), 512)
    jl, jc = jtransformer.prefill(jp, {"tokens": jnp.asarray(tok)}, jcfg,
                                  max_len=S + 1)
    tl, tc = ttransformer.prefill(tp, {"tokens": torch.from_numpy(tok)},
                                  tcfg, max_len=S + 1)
    _close(tl, jl, 1e-5)
    for name in ("k", "v"):
        _close(tc[name], jc[name], 1e-5)
    nxt = _tokens(20, (B, 1), 512)
    jl, _ = jtransformer.decode_step(jp, jnp.asarray(nxt), jc, jcfg)
    tl, _ = ttransformer.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
    _close(tl, jl, 1e-5)


# -- what waits ----------------------------------------------------------------------
def test_torch_unported_arch_names_its_roadmap_item():
    """No arch of the reference waits any more: llava-next-34b, the last
    (ROADMAP Queue 1 item 6), is ported; an unknown name still raises."""
    assert WAITING == {}
    assert get_config("llava-next-34b").family == "vlm"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


@pytest.mark.parametrize("change", [
    {"family": "vlm", "attention_impl": "blocked"},
    {"attention_impl": "blocked"},
    {"attention_impl": "triangular"},
])
def test_torch_schedule_configs_are_served(change):
    """A config asking for a tiled schedule is served (ROADMAP Queue 1
    item 7, once refused): with blocks of 4 queries and 8 keys an 11-token
    prefill runs the tiles, and it and a decode step give the naive run's
    logits (fp32, 1e-5); the VLM family too."""
    _, tcfg = _configs(attention_block_q=4, attention_block_kv=8, **change)
    model = get_model(tcfg)
    params = model.init(torch.Generator().manual_seed(0), tcfg)
    tok = torch.from_numpy(_tokens(21, (2, 11), tcfg.vocab_size)).long()
    nxt = torch.from_numpy(_tokens(22, (2, 1), tcfg.vocab_size)).long()
    out = {}
    for cfg in (tcfg, tcfg.replace(attention_impl="naive")):
        logits, cache = model.prefill(params, {"tokens": tok}, cfg,
                                      max_len=12)
        step, _ = model.decode_step(params, nxt, cache, cfg)
        out[cfg.attention_impl] = (logits, step)
    for got, want in zip(out[change["attention_impl"]], out["naive"]):
        _close(got, want.numpy(), 1e-5)


def test_torch_dense_path_refuses_a_window_and_says_why():
    """A window on the dense transformer stays refused, with the reason:
    the reference's dense path sizes its cache by the window but attends
    without one, so no reference config defines it. The window itself is
    served by the hybrid family (tests/test_torch_rglru.py)."""
    _, tcfg = _configs(local_window=64)
    model = get_model(tcfg)
    assert model is ttransformer
    params = model.init(torch.Generator().manual_seed(0), tcfg)
    tok = torch.zeros((1, 3), dtype=torch.long)
    with pytest.raises(NotImplementedError,
                       match="sizes this path's cache by the window but "
                             "attends without one") as err:
        model.prefill(params, {"tokens": tok}, tcfg)
    assert str(err.value) == ttransformer.DENSE_WINDOW_REFUSED
