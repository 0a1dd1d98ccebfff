"""The port's hybrid family (recurrentgemma) against the reference, on the
CPU: the RG-LRU scan and its step, the causal conv, the recurrent block,
the sliding-window attention and its rolling cache, the logit soft cap,
``prefill``/``decode_step`` past the window, and ``run_serve`` at
recurrentgemma-2b's ``reduced()`` size (window 8).

The same weights (the reference's random init, converted by
``repro_torch.models.convert.params_from_jax``) and the same numpy inputs
go through ``repro.models`` and ``repro_torch.models``. Tolerances: the
counterparts of tests/test_models.py keep theirs (scan against stepwise
2e-5, the wrapped window cache against full attention 2e-4); fp32 against
JAX is held to 1e-5 (the reductions' round-off; the doubling scan and
``jax.lax.associative_scan`` associate the same products in another order,
which the recurrence's |a| <= 1 keeps from growing), bf16 to 2e-2 of the
largest magnitude compared (tests/test_kernels.py's bf16 tolerance, as
tests/test_torch_models.py holds the dense stack).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro_torch.configs import ARCHS, WAITING, get_config
from repro_torch.launch.serve import parse_args, run_serve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import rglru as trglru
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from repro_torch.models.registry import get_model

ARCH = "recurrentgemma-2b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SCAN_TOL = 2e-5            # tests/test_models.py:137
WINDOW_TOL = 2e-4          # tests/test_models.py:202


def _configs(dtype="float32", **kw):
    kw = dict(dtype=dtype, param_dtype=dtype, **kw)
    return (jax_get_config(ARCH, reduced=True).replace(**kw),
            get_config(ARCH, reduced=True).replace(**kw))


def _params(jcfg, tcfg, seed=0):
    jp = jrglru.init(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)


def _rec_params(seed, dtype="float32"):
    """One recurrent block's params, the reference's init converted."""
    jcfg, tcfg = _configs(dtype)
    jp = jrglru._init_rec_block(jax.random.PRNGKey(seed), jcfg,
                                jnp.dtype(dtype))
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


def _t(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


# the reference's serve functions, compiled once a shape (the config is
# static) so that a decode loop does not run op by op
_jprefill = jax.jit(jrglru.prefill, static_argnums=(2, 3))
_jdecode = jax.jit(jrglru.decode_step, static_argnums=3)


# -- the config -------------------------------------------------------------------
def test_torch_recurrentgemma_config_has_the_reference_numbers():
    """Every field the port shares with the reference holds its value at
    the full config and at reduced(); the family is served by ``rglru``
    and the embeddings are scaled, as the reference decides by the
    name."""
    assert ARCH in ARCHS and ARCH not in WAITING
    for reduced in (False, True):
        jcfg = jax_get_config(ARCH, reduced=reduced)
        tcfg = get_config(ARCH, reduced=reduced)
        for f in ("name", "family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "d_ff", "vocab_size", "head_dim",
                  "hidden_act", "mlp_gated", "norm", "norm_offset",
                  "rope_theta", "tie_embeddings", "local_window",
                  "is_encoder_decoder", "dtype", "param_dtype",
                  "block_pattern", "lru_width", "conv_width",
                  "logits_soft_cap"):
            assert getattr(tcfg, f) == getattr(jcfg, f), (reduced, f)
        assert tcfg.embed_scale and get_model(tcfg) is trglru
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.local_window,
            full.lru_width, full.vocab_size) == (26, 2560, 2048, 2560,
                                                 256000)
    assert trglru.layer_kinds(full)[:6] == ["rec", "rec", "attn"] * 2


def test_torch_init_tree_matches_the_reference():
    """The same keys, shapes and dtypes as the reference's tree (RG-LRU's
    ``lam``, ``ba`` and ``bx`` fp32 in a bf16 model), and the same
    deterministic leaves."""
    jcfg, tcfg = _configs("bfloat16")
    jp = jax.tree_util.tree_map(
        np.asarray, jrglru.init(jax.random.PRNGKey(0), jcfg))
    tp = trglru.init(torch.Generator().manual_seed(0), tcfg)
    jflat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    tflat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            tflat[path] = node

    walk(tp, ())
    want = {tuple(k.key for k in path): leaf for path, leaf in jflat.items()}
    assert set(tflat) == set(want)
    for path, leaf in want.items():
        got = tflat[path]
        assert tuple(got.shape) == leaf.shape, path
        assert str(got.dtype).removeprefix("torch.") == leaf.dtype.name, path
    for name in ("lam", "ba", "bx", "conv_b"):
        _close(tp["layer_00"]["rec"][name], want[("layer_00", "rec", name)],
               0.0)


# -- the RG-LRU, the conv and the recurrent block ------------------------------------
def test_torch_rglru_scan_equals_stepwise():
    """The counterpart of tests/test_models.py::test_rglru_scan_equals_
    stepwise, on the port's own scan and step."""
    _, p = _rec_params(6)
    B, T, W = 2, 9, get_config(ARCH, reduced=True).lru_width
    x = torch.from_numpy(_normal(7, (B, T, W)))
    h0 = torch.zeros(B, W)
    y_par, h_par = trglru._rg_lru(x, p, h0)
    h, ys = h0, []
    for t in range(T):
        y_t, h = trglru._rg_lru_step(x[:, t], p, h)
        ys.append(y_t)
    y_seq = torch.stack(ys, dim=1)
    np.testing.assert_allclose(y_par.numpy(), y_seq.numpy(), rtol=SCAN_TOL,
                               atol=SCAN_TOL)
    np.testing.assert_allclose(h_par.numpy(), h.numpy(), rtol=SCAN_TOL,
                               atol=SCAN_TOL)


@pytest.mark.parametrize("T", [1, 2, 9, 37, 64])
def test_torch_rg_lru_matches_the_reference(T):
    """The scan at lengths around and between powers of two, from a
    non-zero state, against ``jax.lax.associative_scan``'s."""
    jp, tp = _rec_params(8)
    W = get_config(ARCH, reduced=True).lru_width
    x, h0 = _normal(9, (2, T, W)), _normal(10, (2, W))
    y, h = trglru._rg_lru(torch.from_numpy(x), tp, torch.from_numpy(h0))
    jy, jh = jrglru._rg_lru(jnp.asarray(x), jp, jnp.asarray(h0))
    _close(y, jy, TOL["float32"])
    _close(h, jh, TOL["float32"])
    assert h.dtype == torch.float32
    y1, h1 = trglru._rg_lru_step(torch.from_numpy(x[:, 0]), tp,
                                 torch.from_numpy(h0))
    jy1, jh1 = jrglru._rg_lru_step(jnp.asarray(x[:, 0]), jp, jnp.asarray(h0))
    _close(y1, jy1, TOL["float32"])
    _close(h1, jh1, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 7])
def test_torch_causal_conv_matches_the_reference(dtype, T):
    W, cw = 64, 4
    x, w = _normal(11, (2, T, W)), _normal(12, (cw, W))
    b, tail = _normal(13, (W,)), _normal(14, (2, cw - 1, W))
    y, new_tail = trglru._causal_conv(_t(x, dtype), _t(w, dtype),
                                      _t(b, dtype), _t(tail, dtype))
    jy, jtail = jrglru._causal_conv(
        jnp.asarray(x, dtype), jnp.asarray(w, dtype), jnp.asarray(b, dtype),
        jnp.asarray(tail, dtype))
    assert y.dtype == new_tail.dtype == getattr(torch, dtype)
    _close(y, jy, TOL[dtype])
    _close(new_tail, jtail, 0.0)       # a copy of inputs: exact


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 11])
def test_torch_rec_block_matches_the_reference(dtype, T):
    """The whole recurrent block, prefill (T > 1, the scan) and decode
    (T = 1, the step), from a non-zero state: output, LRU state (fp32)
    and conv tail."""
    jp, tp = _rec_params(15, dtype)
    D, W = 64, 64
    x = _normal(16, (2, T, D))
    h0, conv = _normal(17, (2, W)), _normal(18, (2, 3, W)) * 0.5
    out, st = trglru._rec_block(
        _t(x, dtype), tp, {"h": torch.from_numpy(h0),
                           "conv": _t(conv, dtype)})
    jout, jst = jrglru._rec_block(
        jnp.asarray(x, dtype), jp, {"h": jnp.asarray(h0),
                                    "conv": jnp.asarray(conv, dtype)})
    assert out.dtype == getattr(torch, dtype) and st["h"].dtype == \
        torch.float32
    _close(out, jout, TOL[dtype])
    _close(st["h"], jst["h"], TOL[dtype])
    _close(st["conv"], jst["conv"], TOL[dtype])


# -- the sliding window -------------------------------------------------------------
def test_torch_sliding_window_cache_wraps_correctly():
    """The counterpart of tests/test_models.py::test_sliding_window_cache_
    wraps_correctly: decode past the window; the rolling buffer equals
    full attention restricted to the window."""
    _, cfg = _configs(attention_impl="naive")
    params = tattn.init_attention(torch.Generator().manual_seed(14), cfg,
                                  torch.float32)
    B, W = 1, cfg.local_window
    T = W + 6                                  # force wraparound
    x = torch.from_numpy(_normal(15, (B, T, cfg.d_model)))
    pos = torch.arange(T).expand(B, T)
    full, _ = tattn.attention_layer(x, params, cfg, pos, window=W)
    cache = tattn.init_cache(cfg, B, max_len=T, device=x.device,
                             dtype=torch.float32, window=W)
    assert cache["k"].shape[1] == W
    outs = []
    for t in range(T):
        o, cache = tattn.attention_layer(x[:, t:t + 1], params, cfg,
                                         pos[:, t:t + 1], cache=cache,
                                         window=W)
        outs.append(o)
    step = torch.cat(outs, dim=1)
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=WINDOW_TOL,
                               atol=WINDOW_TOL)


@pytest.mark.parametrize("S", [5, 8, 13, 21])
def test_torch_windowed_attention_layer_matches_the_reference(S):
    """A windowed prefill of S tokens into a cache of min(window, max_len)
    slots (S at, under and over the window: the rotation), then decode
    steps that wrap: outputs and cache buffers against the reference's."""
    jcfg, tcfg = _configs()
    W = tcfg.local_window
    jp, _ = jattn.init_attention(jax.random.PRNGKey(20), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    B, steps = 2, 11
    x = _normal(21, (B, S + steps, 64))
    pos = np.broadcast_to(np.arange(S + steps), (B, S + steps))
    jc = jattn.init_cache(jcfg, B, S + steps, window=W, dtype=jnp.float32)
    tc = tattn.init_cache(tcfg, B, S + steps, torch.device("cpu"),
                          dtype=torch.float32, window=W)
    jlayer = jax.jit(lambda x, p, pos, cache: jattn.attention_layer(
        x, p, jcfg, pos, cache=cache, window=W))
    for lo, hi in [(0, S)] + [(t, t + 1) for t in range(S, S + steps)]:
        jo, jc = jlayer(jnp.asarray(x[:, lo:hi]), jp,
                        jnp.asarray(pos[:, lo:hi]), jc)
        to, tc = tattn.attention_layer(
            torch.from_numpy(x[:, lo:hi]), tp, tcfg,
            torch.from_numpy(np.ascontiguousarray(pos[:, lo:hi])),
            cache=tc, window=W)
        _close(to, jo, TOL["float32"])
        for name in ("k", "v"):
            _close(tc[name], jc[name], TOL["float32"])
        assert tc["pos"] == int(jc["pos"]) == hi


# -- the soft cap ---------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_logit_soft_cap_matches_the_reference(dtype):
    """``cap · tanh(logits / cap)`` in the logits' dtype, on logits up to
    ~90, well past the cap of 30."""
    jcfg, tcfg = _configs(dtype)
    assert tcfg.logits_soft_cap == 30.0
    x = _normal(22, (2, 3, 64)) * 4.0
    tok = _normal(23, (256, 64))
    got = tlayers.lm_logits(_t(x, dtype), {"tok": _t(tok, dtype)}, tcfg)
    want = jlayers.lm_logits(jnp.asarray(x, dtype),
                             {"tok": jnp.asarray(tok, dtype)}, jcfg)
    assert got.dtype == getattr(torch, dtype)
    assert float(np.abs(np.asarray(want, np.float32)).max()) <= 30.0
    _close(got, want, TOL[dtype])
    uncapped = tlayers.lm_logits(_t(x, dtype), {"tok": _t(tok, dtype)},
                                 tcfg.replace(logits_soft_cap=0.0))
    assert float(uncapped.float().abs().max()) > 30.0


# -- prefill and decode past the window ------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [5, 13])
def test_torch_prefill_then_decode_past_the_window_matches_jax(dtype, S):
    """Prefill (under and over the window of 8) and 10 decode steps, every
    step's logits and the final caches against the reference's."""
    jcfg, tcfg = _configs(dtype)
    jp, tp = _params(jcfg, tcfg, seed=3)
    B, steps = 2, 10
    tok = _tokens(24, (B, S), tcfg.vocab_size)
    jl, jc = _jprefill(jp, {"tokens": jnp.asarray(tok)}, jcfg, S + steps)
    tl, tc = trglru.prefill(tp, {"tokens": torch.from_numpy(tok).long()},
                            tcfg, max_len=S + steps)
    _close(tl, jl, TOL[dtype])
    for k in range(steps):
        nxt = _tokens(25 + k, (B, 1), tcfg.vocab_size)
        jl, jc = _jdecode(jp, jnp.asarray(nxt), jc, jcfg)
        tl, tc = trglru.decode_step(tp, torch.from_numpy(nxt).long(), tc,
                                    tcfg)
        _close(tl, jl, TOL[dtype])
    assert tc["pos"] == int(jc["pos"]) == S + steps
    for key, layer in jc.items():
        if key == "pos":
            continue
        for name, buf in layer.items():
            _close(tc[key][name], buf, TOL[dtype])


def test_torch_hybrid_serve_invariant_past_the_window():
    """Greedy prefill + decode equals the argmax of teacher-forced
    prefills, in fp32, with every decode step past the window."""
    _, tcfg = _configs()
    params = trglru.init(torch.Generator().manual_seed(4), tcfg)
    tok = torch.from_numpy(_tokens(26, (2, 10), tcfg.vocab_size)).long()
    steps = 6
    logits, cache = trglru.prefill(params, {"tokens": tok}, tcfg,
                                   max_len=10 + steps)
    seq = tok
    for _ in range(steps):
        nxt = logits[:, -1:].argmax(-1)
        forced, _ = trglru.prefill(params, {"tokens": seq}, tcfg)
        assert torch.equal(forced[:, -1:].argmax(-1), nxt)
        seq = torch.cat([seq, nxt], dim=1)
        logits, cache = trglru.decode_step(params, nxt, cache, tcfg)


# -- serving ---------------------------------------------------------------------------
def test_torch_serve_recurrentgemma_matches_the_jax_model():
    """``run_serve --arch recurrentgemma-2b --reduced`` (prompts of 12
    tokens, over the window of 8, and 6 out) on the reference's weights in
    fp32: the reference's greedy tokens, batch by batch, and no kernel
    launched."""
    args = parse_args(["--arch", ARCH, "--reduced", "--requests", "6",
                       "--batch", "4", "--prompt-len", "12", "--gen", "6",
                       "--seed", "5"])
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg, seed=2)
    res = run_serve(args, device="cpu", params=tp, config=tcfg)
    assert set(res["launches"].values()) == {0}
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, jcfg.vocab_size, (args.prompt_len,),
                            dtype=np.int32) for _ in range(args.requests)]
    for lo in range(0, args.requests, args.batch):
        batch = prompts[lo:lo + args.batch]
        batch += [batch[-1]] * (args.batch - len(batch))
        logits, cache = _jprefill(
            jp, {"tokens": jnp.asarray(np.stack(batch))}, jcfg,
            args.prompt_len + args.gen)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        outs = [np.asarray(tok)[:, 0]]
        for _ in range(args.gen - 1):
            logits, cache = _jdecode(jp, tok, cache, jcfg)
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            outs.append(np.asarray(tok)[:, 0])
        want = np.stack(outs, axis=1)
        for i in range(min(args.batch, args.requests - lo)):
            assert res["results"][lo + i] == want[i].tolist(), lo + i


def test_torch_serve_recurrentgemma_draws_its_weights_from_the_seed():
    args = parse_args(["--arch", ARCH, "--reduced", "--requests", "2",
                       "--batch", "2", "--prompt-len", "10", "--gen", "3"])
    a = run_serve(args, device="cpu")
    assert a["results"] == run_serve(args, device="cpu")["results"]
    assert a["config"].family == "hybrid" and a["tokens"] == 6


def test_torch_converted_hybrid_leaves_keep_their_dtypes():
    jcfg, tcfg = _configs("bfloat16")
    jp, tp = _params(jcfg, tcfg)
    rec = tp["layer_00"]["rec"]
    assert {rec[n].dtype for n in ("lam", "ba", "bx")} == {torch.float32}
    assert rec["wa"].dtype == torch.bfloat16
    assert torch.equal(tp["layer_02"]["attn"]["wq"], tensor_from_numpy(
        np.asarray(jp["layer_02"]["attn"]["wq"])))
