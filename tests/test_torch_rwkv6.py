"""The port's ssm family (rwkv6) against the reference, on the CPU: the
three WKV evaluations against each other and against their JAX twins, the
time and channel mixes, ``prefill``/``decode_step`` with every state leaf,
the serve invariant, ``params_from_jax`` and ``run_serve`` at rwkv6-7b's
``reduced()`` size (4 heads of 16, chunk 4, decay LoRA 8).

The same weights (the reference's random init, converted by
``repro_torch.models.convert.params_from_jax``) and the same numpy inputs
go through ``repro.models`` and ``repro_torch.models``. Tolerances: the
counterparts of tests/test_models.py keep theirs (chunked against
recurrent 2e-4, the extreme decay 1e-4); fp32 against JAX is held to 1e-5
(the port computes the chunks' state-free terms for all chunks at once,
the same products summed in another order), and a WKV function's output
and state to 1e-5 of the largest magnitude compared: with a non-zero state
they reach ~23, and each package's chunked WKV is 1e-5 to 4e-5 from a
float64 recurrence there. bf16 is held to 2e-2 of the largest magnitude
compared (tests/test_kernels.py's bf16 tolerance, as
tests/test_torch_models.py holds the dense stack).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import rwkv6 as jrwkv
from repro_torch.configs import ARCHS, WAITING, get_config
from repro_torch.launch.serve import parse_args, run_serve
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from repro_torch.models.registry import get_model

ARCH = "rwkv6-7b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CHUNK_TOL = 2e-4           # tests/test_models.py:102
EXTREME_TOL = 1e-4         # tests/test_models.py:119


def _configs(dtype="float32", **kw):
    kw = dict(dtype=dtype, param_dtype=dtype, **kw)
    return (jax_get_config(ARCH, reduced=True).replace(**kw),
            get_config(ARCH, reduced=True).replace(**kw))


def _params(jcfg, tcfg, seed=0):
    jp = jrwkv.init(jax.random.PRNGKey(seed), jcfg)
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


def _close_scaled(got, want, tol=TOL["float32"]):
    """Within ``tol`` of the largest magnitude compared."""
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * scale)


def _t(x, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


def _wkv_inputs(seed, B, T, H, K, decay_scale=2.0):
    """r, k, v standard normal, log w = -exp(2 N - 1) (w from ~0 to ~1), u
    and a non-zero state, as numpy fp32."""
    r, k, v = (_normal(seed + i, (B, T, H, K)) for i in range(3))
    logw = -np.exp(_normal(seed + 3, (B, T, H, K)) * decay_scale - 1.0)
    u = _normal(seed + 4, (H, K))
    s0 = _normal(seed + 5, (B, H, K, K)) * 0.5
    return r, k, v, logw.astype(np.float32), u, s0


# the reference's serve functions, compiled once a shape (the config is
# static) so that a decode loop does not run op by op
_jprefill = jax.jit(jrwkv.prefill, static_argnums=(2, 3))
_jdecode = jax.jit(jrwkv.decode_step, static_argnums=3)


# -- the config -------------------------------------------------------------------
def test_torch_rwkv6_config_has_the_reference_numbers():
    """Every field the port shares with the reference holds its value at
    the full config and at reduced(), the new ones included; the family is
    served by ``rwkv6`` and the embeddings are not scaled."""
    assert ARCH in ARCHS and ARCH not in WAITING
    for reduced in (False, True):
        jcfg = jax_get_config(ARCH, reduced=reduced)
        tcfg = get_config(ARCH, reduced=reduced)
        for f in ("name", "family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "d_ff", "vocab_size", "head_dim",
                  "hidden_act", "mlp_gated", "norm", "norm_offset",
                  "rope_theta", "pos_embedding", "max_position",
                  "tie_embeddings", "rwkv_chunk", "decay_lora",
                  "encoder_layers", "encoder_seq", "is_encoder_decoder",
                  "dtype", "param_dtype", "logits_soft_cap"):
            assert getattr(tcfg, f) == getattr(jcfg, f), (reduced, f)
        assert tcfg.resolved_head_dim == jcfg.resolved_head_dim
        assert not tcfg.embed_scale and get_model(tcfg) is trwkv
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.head_dim,
            full.d_ff, full.vocab_size, full.rwkv_chunk,
            full.decay_lora) == (32, 4096, 64, 64, 14336, 65536, 16, 64)


def test_torch_init_tree_matches_the_reference():
    """The same keys, shapes and dtypes as the reference's tree (``w0`` and
    ``u`` fp32 in a bf16 model), the layers a list, and the same
    deterministic leaves (``mu``, ``cmu``, ``w0``, the group norm's)."""
    jcfg, tcfg = _configs("bfloat16")
    jp = jax.tree_util.tree_map(
        np.asarray, jrwkv.init(jax.random.PRNGKey(0), jcfg))
    tp = trwkv.init(torch.Generator().manual_seed(0), tcfg)
    assert set(tp) == set(jp) == {"embed", "layers", "final_norm"}
    assert len(tp["layers"]) == tcfg.num_layers
    assert set(tp["embed"]) == set(jp["embed"]) == {"tok", "lm_head"}
    for name, leaf in jp["layers"].items():
        for i, layer in enumerate(tp["layers"]):
            if isinstance(leaf, dict):
                for sub, a in leaf.items():
                    assert tuple(layer[name][sub].shape) == a.shape[1:]
                continue
            got = layer[name]
            assert tuple(got.shape) == leaf.shape[1:], name
            assert str(got.dtype).removeprefix("torch.") == \
                leaf.dtype.name, name
            if name in ("mu", "cmu", "w0", "ln_x_scale", "ln_x_bias"):
                _close(got, leaf[i], 0.0)
    assert set(tp["layers"][0]) == set(jp["layers"])


# -- the WKV --------------------------------------------------------------------------
def test_torch_rwkv_chunked_equals_recurrent():
    """The counterpart of tests/test_models.py::test_rwkv_chunked_equals_
    recurrent (B 2, T 21, H 3, K 8, chunk 5: a padded last chunk), on the
    port's own chunked and recurrent WKV from a zero state."""
    r, k, v, logw, u, _ = _wkv_inputs(40, 2, 21, 3, 8)
    s0 = torch.zeros(2, 3, 8, 8)
    y1, st1 = trwkv._wkv_chunked(_t(r), _t(k), _t(v), _t(logw), _t(u), s0,
                                 chunk=5)
    y2, st2 = trwkv._wkv_recurrent(_t(r), _t(k), _t(v), _t(logw), _t(u), s0)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=CHUNK_TOL,
                               atol=CHUNK_TOL)
    np.testing.assert_allclose(st1.numpy(), st2.numpy(), rtol=CHUNK_TOL,
                               atol=CHUNK_TOL)


def test_torch_rwkv_chunked_extreme_decay_is_stable():
    """The counterpart of tests/test_models.py::test_rwkv_chunked_extreme_
    decay_is_stable: w = e^-150 (the overflow trap of a chunked form that
    factors the decay) stays finite and equals the recurrence."""
    r, k, v, _, _, _ = _wkv_inputs(41, 1, 16, 2, 4)
    logw = np.full((1, 16, 2, 4), -150.0, np.float32)
    u = torch.ones(2, 4)
    s0 = torch.zeros(1, 2, 4, 4)
    y, st = trwkv._wkv_chunked(_t(r), _t(k), _t(v), _t(logw), u, s0,
                               chunk=8)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    y2, _ = trwkv._wkv_recurrent(_t(r), _t(k), _t(v), _t(logw), u, s0)
    np.testing.assert_allclose(y.numpy(), y2.numpy(), rtol=EXTREME_TOL,
                               atol=EXTREME_TOL)


@pytest.mark.parametrize("T,chunk", [(1, 4), (3, 4), (16, 4), (21, 5),
                                     (37, 16)])
def test_torch_wkv_functions_match_their_jax_twins(T, chunk):
    """Each WKV function from a non-zero state against its JAX twin: the
    chunked one at T under, at and over a chunk (padded tails included),
    the recurrent one, and the step: outputs and states, fp32, within 1e-5
    of the largest magnitude."""
    B, H, K = 2, 3, 8
    r, k, v, logw, u, s0 = _wkv_inputs(50 + T, B, T, H, K)
    targs = (_t(r), _t(k), _t(v), _t(logw), _t(u), _t(s0))
    jargs = tuple(jnp.asarray(a) for a in (r, k, v, logw, u, s0))
    y, st = trwkv._wkv_chunked(*targs, chunk=chunk)
    jy, jst = jrwkv._wkv_chunked(*jargs, chunk=chunk)
    assert y.shape == (B, T, H, K) and st.dtype == torch.float32
    _close_scaled(y, jy)
    _close_scaled(st, jst)
    y, st = trwkv._wkv_recurrent(*targs)
    jy, jst = jrwkv._wkv_recurrent(*jargs)
    _close_scaled(y, jy)
    _close_scaled(st, jst)
    step = [a[:, 0] for a in targs[:4]] + list(targs[4:])
    y, st = trwkv._wkv_step(*step)
    jy, jst = jrwkv._wkv_step(*([a[:, 0] for a in jargs[:4]]
                                + list(jargs[4:])))
    _close_scaled(y, jy)
    _close_scaled(st, jst)


# -- the block's mixes ---------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,T", [("chunked", 11), ("recurrent", 6),
                                    ("decode", 1)])
def test_torch_time_mix_matches_the_reference(dtype, mode, T):
    """The time mix from a non-zero state in each WKV mode: output and
    state (fp32) against the reference's."""
    jcfg, tcfg = _configs(dtype)
    jp, tp = _params(jcfg, tcfg, seed=7)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    tl = tp["layers"][0]
    D, H, K = tcfg.d_model, tcfg.num_heads, tcfg.resolved_head_dim
    x, xs = _normal(60, (2, T, D)), _normal(61, (2, T, D))
    s0 = _normal(62, (2, H, K, K)) * 0.5
    out, st = trwkv._time_mix(_t(x, dtype), _t(xs, dtype), tl, tcfg,
                              _t(s0), mode)
    jout, jst = jrwkv._time_mix(jnp.asarray(x, dtype), jnp.asarray(xs, dtype),
                                jl, jcfg, jnp.asarray(s0), mode)
    assert out.dtype == getattr(torch, dtype) and st.dtype == torch.float32
    _close(out, jout, TOL[dtype])
    _close(st, jst, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_channel_mix_matches_the_reference(dtype):
    jcfg, tcfg = _configs(dtype)
    jp, tp = _params(jcfg, tcfg, seed=8)
    jl = jax.tree_util.tree_map(lambda a: a[1], jp["layers"])
    x, xs = _normal(63, (2, 9, 64)), _normal(64, (2, 9, 64))
    out = trwkv._channel_mix(_t(x, dtype), _t(xs, dtype), tp["layers"][1],
                             tcfg)
    jout = jrwkv._channel_mix(jnp.asarray(x, dtype), jnp.asarray(xs, dtype),
                              jl, jcfg)
    assert out.dtype == getattr(torch, dtype)
    _close(out, jout, TOL[dtype])


def test_torch_token_shift_carries_the_previous_input():
    x, prev = _normal(65, (2, 5, 8)), _normal(66, (2, 8))
    got = trwkv._token_shift(_t(x), _t(prev))
    _close(got, jrwkv._token_shift(jnp.asarray(x), jnp.asarray(prev)), 0.0)


# -- prefill and decode ------------------------------------------------------------
def _assert_state(ts, js, dtype):
    for name in ("S", "tshift", "cshift"):
        assert tuple(ts[name].shape) == js[name].shape, name
        _close(ts[name], js[name], TOL[dtype])
    assert ts["S"].dtype == torch.float32
    assert ts["tshift"].dtype == getattr(torch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [8, 13])
def test_torch_prefill_then_decode_matches_jax(dtype, S):
    """Prefill of 8 tokens (two whole chunks of 4) and of 13 (a padded last
    chunk), then 5 decode steps: every step's logits and every state leaf
    against the reference's."""
    jcfg, tcfg = _configs(dtype)
    jp, tp = _params(jcfg, tcfg, seed=3)
    B, steps = 2, 5
    tok = _tokens(70 + S, (B, S), tcfg.vocab_size)
    jl, jc = _jprefill(jp, {"tokens": jnp.asarray(tok)}, jcfg, None)
    tl, tc = trwkv.prefill(tp, {"tokens": torch.from_numpy(tok).long()},
                           tcfg)
    _close(tl, jl, TOL[dtype])
    _assert_state(tc, jc, dtype)
    for i in range(steps):
        nxt = _tokens(80 + i, (B, 1), tcfg.vocab_size)
        jl, jc = _jdecode(jp, jnp.asarray(nxt), jc, jcfg)
        tl, tc = trwkv.decode_step(tp, torch.from_numpy(nxt).long(), tc,
                                   tcfg)
        _close(tl, jl, TOL[dtype])
        _assert_state(tc, jc, dtype)
    assert tc["pos"] == int(jc["pos"]) == S + steps


def test_torch_init_cache_ignores_max_len():
    _, tcfg = _configs()
    a = trwkv.init_cache(tcfg, 3, 10, torch.device("cpu"))
    b = trwkv.init_cache(tcfg, 3, 10_000, torch.device("cpu"))
    want = jrwkv.init_cache(_configs()[0], 3, 10)
    for name in ("S", "tshift", "cshift"):
        assert a[name].shape == b[name].shape == want[name].shape
    assert a["pos"] == 0


def test_torch_rwkv_serve_invariant():
    """The port's counterpart of tests/test_models.py::test_prefill_then_
    decode_matches_full_forward for rwkv6-7b: greedy prefill + decode
    equals the argmax of teacher-forced prefills, in fp32."""
    _, tcfg = _configs()
    params = trwkv.init(torch.Generator().manual_seed(1), tcfg)
    B, S, G = 2, 12, 4
    tok = torch.from_numpy(_tokens(90, (B, S), tcfg.vocab_size)).long()
    logits, cache = trwkv.prefill(params, {"tokens": tok}, tcfg,
                                  max_len=S + G)
    serve = [logits[:, -1].argmax(-1)]
    for _ in range(G - 1):
        logits, cache = trwkv.decode_step(params, serve[-1][:, None], cache,
                                          tcfg)
        serve.append(logits[:, -1].argmax(-1))
    full = tok
    for g in range(G):
        forced, _ = trwkv.prefill(params, {"tokens": full}, tcfg)
        nxt = forced[:, -1].argmax(-1)
        assert torch.equal(nxt, serve[g]), g
        full = torch.cat([full, nxt[:, None]], dim=1)


# -- conversion and serving ------------------------------------------------------------
def test_torch_converted_rwkv_leaves_keep_their_dtypes():
    jcfg, tcfg = _configs("bfloat16")
    jp, tp = _params(jcfg, tcfg)
    layer = tp["layers"][1]
    assert layer["w0"].dtype == layer["u"].dtype == torch.float32
    assert layer["w_r"].dtype == torch.bfloat16
    assert torch.equal(layer["u"], tensor_from_numpy(
        np.asarray(jp["layers"]["u"][1])))
    assert torch.equal(tp["embed"]["lm_head"], tensor_from_numpy(
        np.asarray(jp["embed"]["lm_head"])))
    with pytest.raises(ValueError, match="stacked over 3 layers"):
        params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                        tcfg.replace(num_layers=3))


def test_torch_serve_rwkv6_matches_the_jax_model():
    """``run_serve --arch rwkv6-7b --reduced`` on the reference's weights in
    fp32: the reference's greedy tokens, batch by batch, and no kernel
    launched."""
    args = parse_args(["--arch", ARCH, "--reduced", "--requests", "6",
                       "--batch", "4", "--prompt-len", "10", "--gen", "5",
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
            jp, {"tokens": jnp.asarray(np.stack(batch))}, jcfg, None)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        outs = [np.asarray(tok)[:, 0]]
        for _ in range(args.gen - 1):
            logits, cache = _jdecode(jp, tok, cache, jcfg)
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            outs.append(np.asarray(tok)[:, 0])
        want = np.stack(outs, axis=1)
        for i in range(min(args.batch, args.requests - lo)):
            assert res["results"][lo + i] == want[i].tolist(), lo + i


def test_torch_serve_keeps_no_reference_to_its_weights():
    """Once ``run_serve`` returns, the weights it served are freed with the
    caller's last reference: its streaming context stays in the
    process-wide metrics registry (the gauges' callbacks), so it must not
    keep the batch function that holds them (on the card, phase 24's 15 GB
    of bf16 weights stayed beside the fp32 invariant's 30 GB)."""
    import weakref

    _, tcfg = _configs()
    params = trwkv.init(torch.Generator().manual_seed(6), tcfg)
    alive = weakref.ref(params["layers"][0]["w_r"])
    args = parse_args(["--arch", ARCH, "--reduced", "--requests", "2",
                       "--batch", "2", "--prompt-len", "5", "--gen", "2"])
    res = run_serve(args, device="cpu", params=params, config=tcfg)
    assert res["tokens"] == 4
    del params
    assert alive() is None
