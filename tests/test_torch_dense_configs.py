"""The dense configs gemma-7b, minitron-8b and starcoder2-3b in the port,
against the reference, on the CPU.

What these archs add to internlm2-1.8b's layers (tests/test_torch_models.py):
LayerNorm, gemma's (1 + w) RMSNorm, GELU (the tanh form) and squared ReLU,
ungated MLPs, tied embeddings and gemma's sqrt(d_model) embedding scale.
The same weights (the reference's random init, converted by
``params_from_jax``) and the same numpy inputs go through both packages:
each layer, then ``prefill`` and ``decode_step`` at each arch's
``reduced()``, each arch at its full widths in one layer, and the serving
entry point. fp32 is held to 1e-5, bf16 to 2e-2 of the largest magnitude
compared, as in tests/test_torch_models.py. On the CPU the attention is
the naive version; the flash kernels' own checks at hd 128 and 256 are in
test_torch_kernels.py and, on the card, in chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch.configs import REFERENCE_ARCHS, get_config
from repro_torch.launch.serve import parse_args, run_serve
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from repro_torch.models.registry import get_model

DENSE = ("gemma-7b", "minitron-8b", "starcoder2-3b")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _configs(arch, dtype="float32", reduced=True, **kw):
    """The reference's and the port's config, the same numbers."""
    kw = dict(dtype=dtype, param_dtype=dtype, **kw)
    return (jax_get_config(arch, reduced=reduced).replace(**kw),
            get_config(arch, reduced=reduced).replace(**kw))


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


def _t(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


# -- the configs -----------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_torch_dense_config_has_the_reference_numbers(arch):
    """Every field the port shares with the reference holds the same
    value, at the full config and at reduced(), head padding included."""
    for reduced in (False, True):
        jcfg = jax_get_config(arch, reduced=reduced)
        tcfg = get_config(arch, reduced=reduced)
        for f in ("name", "family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "d_ff", "vocab_size", "head_dim",
                  "hidden_act", "mlp_gated", "norm", "norm_offset",
                  "rope_theta", "tie_embeddings", "local_window",
                  "is_encoder_decoder", "dtype", "param_dtype",
                  "pad_attention_heads"):
            assert getattr(tcfg, f) == getattr(jcfg, f), (reduced, f)
        assert tcfg.resolved_head_dim == jcfg.resolved_head_dim


@pytest.mark.parametrize("arch", sorted(REFERENCE_ARCHS))
def test_torch_embed_scale_is_the_reference_name_test(arch):
    """``embed_scale``, set in gemma-7b's and recurrentgemma-2b's config
    files, says what the reference decides from the name
    (``layers.py:135``): those two scale, no other ported arch does."""
    name = jax_get_config(arch).name
    want = name.startswith("gemma") or name.startswith("recurrentgemma")
    assert get_config(arch).embed_scale is want
    assert get_config(arch, reduced=True).embed_scale is want
    assert want is (arch in ("gemma-7b", "recurrentgemma-2b"))


# -- layers ----------------------------------------------------------------------
@pytest.mark.parametrize("width", [64, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_layernorm(width, dtype):
    """At reduced()'s width and minitron-8b's; scale and bias are drawn,
    so both reach the output."""
    x = _normal(31, (3, 5, width)) * 3 + 1
    w, b = _normal(32, (width,)), _normal(33, (width,))
    got = tlayers.layernorm(_t(x, dtype), torch.from_numpy(w),
                            torch.from_numpy(b))
    want = jlayers.layernorm(jnp.asarray(x, dtype), jnp.asarray(w),
                             jnp.asarray(b))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_rmsnorm_offset(offset, dtype):
    """Gemma's (1 + w) scale and the plain one, at gemma-7b's width."""
    x, w = _normal(34, (3, 5, 3072)), _normal(35, (3072,))
    got = tlayers.rmsnorm(_t(x, dtype), torch.from_numpy(w), offset=offset)
    want = jlayers.rmsnorm(jnp.asarray(x, dtype), jnp.asarray(w),
                           offset=offset)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("arch", DENSE)
def test_torch_init_norm_matches_the_reference(arch):
    """LayerNorm: scale 1 and bias 0; gemma's offset RMSNorm: scale 0, so
    that (1 + w) starts at 1."""
    jcfg, tcfg = _configs(arch)
    jn, _ = jlayers.init_norm(jcfg, jnp.float32)
    tn = tlayers.init_norm(tcfg, torch.float32, torch.device("cpu"))
    assert set(tn) == set(jn)
    for k in jn:
        np.testing.assert_array_equal(tn[k].numpy(), np.asarray(jn[k]))


@pytest.mark.parametrize("kind", ["silu", "gelu", "relu2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_activation(kind, dtype):
    """GELU is ``jax.nn.gelu``'s default tanh form: the erf form is ~1e-3
    away, which the fp32 tolerance would catch."""
    x = _normal(36, (4, 257)) * 3
    got = tlayers.activation(_t(x, dtype), kind)
    want = jlayers.activation(jnp.asarray(x, dtype), kind)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, TOL[dtype])
    if kind == "gelu" and dtype == "float32":
        erf = torch.nn.functional.gelu(torch.from_numpy(x))
        assert np.abs(erf.numpy() - np.asarray(want)).max() > 1e-4


def test_torch_activation_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown activation"):
        tlayers.activation(torch.zeros(2), "tanh")


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_dense_mlp(arch, dtype):
    """gemma's gated GELU, minitron's ungated squared ReLU, starcoder2's
    ungated GELU; an ungated MLP has no ``w_gate``."""
    jcfg, tcfg = _configs(arch, dtype)
    jp, _ = jlayers.init_mlp(jax.random.PRNGKey(37), jcfg, jnp.dtype(dtype))
    assert ("w_gate" in jp) is jcfg.mlp_gated
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    x = _normal(38, (2, 5, jcfg.d_model))
    got = tlayers.mlp(_t(x, dtype), tp, tcfg)
    want = jlayers.mlp(jnp.asarray(x, dtype), jp, jcfg)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_embed_tokens_scaled(reduced, dtype):
    """gemma-7b's rows times sqrt(d_model) in the activation dtype, at
    reduced()'s width (8) and the full one (sqrt(3072) = 55.43, 55.5 in
    bf16); bit for bit. The full table is cut to 512 rows."""
    jcfg, tcfg = _configs("gemma-7b", dtype, reduced=reduced,
                          vocab_size=512)
    jp, _ = jlayers.init_embedding(jax.random.PRNGKey(39), jcfg, jnp.float32)
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    tok = _tokens(40, (2, 6), jcfg.vocab_size)
    got = tlayers.embed_tokens(torch.from_numpy(tok).long(), tp, tcfg)
    want = jlayers.embed_tokens(jnp.asarray(tok), jp, jcfg)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    plain = tp["tok"].to(getattr(torch, dtype))[torch.from_numpy(tok).long()]
    assert not torch.equal(got, plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_lm_logits_tied(dtype):
    """The tied head, x @ tok^T: the tree has no ``lm_head``."""
    jcfg, tcfg = _configs("gemma-7b", dtype)
    jp, _ = jlayers.init_embedding(jax.random.PRNGKey(41), jcfg, jnp.float32)
    assert set(jp) == {"tok"}
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    x = _normal(42, (2, 3, jcfg.d_model)) * 4
    got = tlayers.lm_logits(_t(x, dtype), tp, tcfg)
    want = jlayers.lm_logits(jnp.asarray(x, dtype), jp, jcfg)
    assert got.shape == (2, 3, jcfg.vocab_size)
    _close(got, want, TOL[dtype])


# -- the model -------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_torch_init_builds_the_reference_tree(arch):
    """The port's ``init`` builds the reference's keys and shapes (a tied
    tree without ``lm_head``, LayerNorm's ``bias``, no ``w_gate`` in an
    ungated MLP), and ``params_from_jax`` carries the reference's tree
    over leaf for leaf."""
    jcfg, tcfg = _configs(arch)
    jp, conv = _params(jcfg, tcfg, seed=5)
    own = ttransformer.init(torch.Generator().manual_seed(5), tcfg)
    for tree in (own, conv):
        assert len(tree["layers"]) == jcfg.num_layers
        for top in ("embed", "final_norm"):
            assert {k: tuple(v.shape) for k, v in tree[top].items()} == {
                k: v.shape for k, v in jp[top].items()}, top
        for layer in tree["layers"]:
            assert {g: {k: tuple(v.shape) for k, v in sub.items()}
                    for g, sub in layer.items()} == {
                g: {k: v.shape[1:] for k, v in sub.items()}
                for g, sub in jp["layers"].items()}
    for g, sub in jp["layers"].items():
        for k, v in sub.items():
            for i, layer in enumerate(conv["layers"]):
                np.testing.assert_array_equal(layer[g][k].numpy(),
                                              np.asarray(v[i]))


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_dense_prefill_and_decode_match_jax(arch, dtype):
    """``prefill`` logits and cache, then 4 ``decode_step``s fed the same
    tokens, at reduced() (2 layers of 4 heads of 16)."""
    jcfg, tcfg = _configs(arch, dtype)
    jp, tp = _params(jcfg, tcfg)
    B, S, G = 2, 11, 4
    tok = _tokens(43, (B, S), jcfg.vocab_size)
    jl, jc = jtransformer.prefill(jp, {"tokens": jnp.asarray(tok)}, jcfg,
                                  max_len=S + G)
    tl, tc = ttransformer.prefill(tp, {"tokens": torch.from_numpy(tok)},
                                  tcfg, max_len=S + G)
    tol = TOL[dtype]
    assert tl.shape == (B, 1, jcfg.vocab_size) and tc["pos"] == S
    assert tc["k"].shape == (2, B, S + G, jcfg.num_kv_heads, 16)
    _close(tl, jl, tol)
    for name in ("k", "v"):
        _close(tc[name], jc[name], tol)
    steps = _tokens(44, (G, B, 1), jcfg.vocab_size)
    for g in range(G):
        jl, jc = jtransformer.decode_step(jp, jnp.asarray(steps[g]), jc, jcfg)
        tl, tc = ttransformer.decode_step(tp, torch.from_numpy(steps[g]),
                                          tc, tcfg)
        assert tc["pos"] == int(jc["pos"]) == S + g + 1
        _close(tl, jl, tol)
    for name in ("k", "v"):
        _close(tc[name], jc[name], tol)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("impl", ["flash", "naive"])
def test_torch_dense_prefill_then_decode_matches_full_forward(arch, impl):
    """tests/test_models.py:45-84 on the port: greedy prefill + decode_step
    equals the argmax of teacher-forced prefills."""
    _, tcfg = _configs(arch, attention_impl=impl)
    model = get_model(tcfg)
    params = model.init(torch.Generator().manual_seed(1), tcfg)
    B, S, G = 2, 12, 4
    tokens = torch.from_numpy(_tokens(45, (B, S), tcfg.vocab_size)).long()
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


# gemma-7b's d_ff is cut from 24,576 to 8,192 here: its full MLP in one
# layer is 226 M fp32 parameters a package, more host memory than a CPU
# test should take; every other width is the published one
FULL_WIDTH_CUTS = {"gemma-7b": {"d_ff": 8192}}


@pytest.mark.parametrize("arch,widths", [
    ("gemma-7b", (3072, 16, 16, 256, 8192)),
    ("minitron-8b", (4096, 32, 8, 128, 16384)),
    ("starcoder2-3b", (3072, 24, 2, 128, 12288)),
])
def test_torch_dense_full_widths_one_layer(arch, widths):
    """Each arch's full widths (d_model, query and KV heads, head dim,
    d_ff) in one layer with a 512-token vocabulary, fp32: gemma's hd 256
    and scaled, tied embeddings, minitron's 32/8 GQA and LayerNorm,
    starcoder2's 24/2 GQA and theta 100,000. Prefill logits and cache,
    then one decode step."""
    kw = dict(num_layers=1, vocab_size=512, **FULL_WIDTH_CUTS.get(arch, {}))
    jcfg, tcfg = _configs(arch, reduced=False, **kw)
    assert (tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads,
            tcfg.resolved_head_dim, tcfg.d_ff) == widths
    jp, tp = _params(jcfg, tcfg, seed=6)
    B, S = 2, 16
    tok = _tokens(46, (B, S), 512)
    jl, jc = jtransformer.prefill(jp, {"tokens": jnp.asarray(tok)}, jcfg,
                                  max_len=S + 1)
    tl, tc = ttransformer.prefill(tp, {"tokens": torch.from_numpy(tok)},
                                  tcfg, max_len=S + 1)
    _close(tl, jl, 1e-5)
    for name in ("k", "v"):
        _close(tc[name], jc[name], 1e-5)
    nxt = _tokens(47, (B, 1), 512)
    jl, _ = jtransformer.decode_step(jp, jnp.asarray(nxt), jc, jcfg)
    tl, _ = ttransformer.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
    _close(tl, jl, 1e-5)


# -- the serving entry point -------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_torch_serve_dense_arch_matches_the_jax_model(arch):
    """``run_serve --arch <arch> --reduced`` (5 requests in batches of 4,
    so the last is padded) on the reference's weights in fp32 gives the
    greedy tokens of the reference's prefill/decode_step on the same
    prompts, and launches nothing on the CPU."""
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


@pytest.mark.parametrize("arch", DENSE)
def test_torch_serve_draws_a_dense_arch_from_the_seed(arch):
    """Without weights, ``run_serve --arch <arch> --reduced`` draws the
    arch's own tree from --seed: two runs agree."""
    args = parse_args(["--arch", arch, "--reduced", "--requests", "2",
                       "--batch", "2", "--prompt-len", "5", "--gen", "2"])
    a = run_serve(args, device="cpu")
    assert a["config"].name == arch
    assert a["results"] == run_serve(args, device="cpu")["results"]
