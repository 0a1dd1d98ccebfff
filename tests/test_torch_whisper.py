"""The port's audio family (whisper) against the reference, on the CPU: the
learned positions, the encoder, cross-attention with ``kv_source`` and
with ``precomputed_kv``, ``prefill`` with every cache leaf and three
``decode_step``s, the serve invariant, which attention calls the flash
kernel would take, ``params_from_jax`` and ``run_serve`` at
whisper-medium's ``reduced()`` size (2 + 2 layers, 4 heads of 16, 12
frames), with the encoder made deeper than the decoder where the two
stacks could be confused.

The same weights (the reference's random init, converted by
``repro_torch.models.convert.params_from_jax``) and the same numpy inputs
go through ``repro.models`` and ``repro_torch.models``. Prompts are 7
tokens long, not the 12 frames, so a cache or mask that mixed the two
lengths would show. fp32 is held to 1e-5 (the reductions' round-off),
bf16 to 2e-2 of the largest magnitude compared (tests/test_kernels.py's
bf16 tolerance, as tests/test_torch_models.py holds the dense stack).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import whisper as jwhisper
from repro_torch.configs import ARCHS, WAITING, get_config
from repro_torch.launch.serve import parse_args, run_serve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import whisper as twhisper
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from repro_torch.models.registry import get_model

ARCH = "whisper-medium"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PROMPT = 7                 # != reduced()'s encoder_seq of 12


def _configs(dtype="float32", **kw):
    kw = dict(dtype=dtype, param_dtype=dtype, **kw)
    return (jax_get_config(ARCH, reduced=True).replace(**kw),
            get_config(ARCH, reduced=True).replace(**kw))


def _params(jcfg, tcfg, seed=0):
    jp = jwhisper.init(jax.random.PRNGKey(seed), jcfg)
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


def _t(x, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


# the reference's serve functions, compiled once a shape (the config is
# static) so that a decode loop does not run op by op
_jprefill = jax.jit(jwhisper.prefill, static_argnums=(2, 3))
_jdecode = jax.jit(jwhisper.decode_step, static_argnums=3)


# -- the config -------------------------------------------------------------------
def test_torch_whisper_config_has_the_reference_numbers():
    """Every field the port shares with the reference holds its value at
    the full config and at reduced(), the new ones included; the family is
    served by ``whisper`` and the embeddings are not scaled."""
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
        assert not tcfg.embed_scale and get_model(tcfg) is twhisper
    full = get_config(ARCH)
    assert (full.num_layers, full.encoder_layers, full.encoder_seq,
            full.d_model, full.num_heads, full.head_dim, full.vocab_size,
            full.max_position) == (24, 24, 1500, 1024, 16, 64, 51865, 32776)


def test_torch_init_tree_matches_the_reference():
    """The same keys, shapes and dtypes as the reference's tree, with 3
    encoder and 2 decoder layers: the stacks are lists of their own
    depths, and ``embed.pos`` and ``enc_pos`` are there."""
    jcfg, tcfg = _configs("bfloat16", encoder_layers=3)
    jp = jax.tree_util.tree_map(
        np.asarray, jwhisper.init(jax.random.PRNGKey(0), jcfg))
    tp = twhisper.init(torch.Generator().manual_seed(0), tcfg)
    assert set(tp) == set(jp)
    assert set(tp["embed"]) == set(jp["embed"]) == {"tok", "pos"}
    assert len(tp["encoder"]) == 3 and len(tp["decoder"]) == 2
    for stack in ("encoder", "decoder"):
        jflat = jax.tree_util.tree_flatten_with_path(jp[stack])[0]
        for path, leaf in jflat:
            keys = [k.key for k in path]
            for layer in tp[stack]:
                got = layer
                for k in keys:
                    got = got[k]
                assert tuple(got.shape) == leaf.shape[1:], (stack, keys)
                assert str(got.dtype).removeprefix("torch.") == \
                    leaf.dtype.name
        assert set(tp[stack][0]) == set(jp[stack])
    assert tuple(tp["enc_pos"].shape) == jp["enc_pos"].shape
    assert tuple(tp["embed"]["pos"].shape) == jp["embed"]["pos"].shape


# -- learned positions ----------------------------------------------------------------
@pytest.mark.parametrize("max_position,rows", [(128, 128), (0, 8192)])
def test_torch_learned_position_table(max_position, rows):
    """``init_embedding`` draws ``pos`` (max_position or 8,192 rows) at std
    0.02 with learned positions, and no table for RoPE or none."""
    _, tcfg = _configs(max_position=max_position)
    emb = tlayers.init_embedding(torch.Generator().manual_seed(1), tcfg,
                                 torch.float32)
    assert tuple(emb["pos"].shape) == (rows, tcfg.d_model)
    assert abs(float(emb["pos"].std()) - 0.02) < 0.002
    jemb, _ = jlayers.init_embedding(jax.random.PRNGKey(1),
                                     _configs(max_position=max_position)[0],
                                     jnp.float32)
    assert set(emb) == set(jemb)
    for pos_embedding in ("rope", "none"):
        emb = tlayers.init_embedding(
            torch.Generator().manual_seed(1),
            tcfg.replace(pos_embedding=pos_embedding), torch.float32)
        assert "pos" not in emb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("start", [0, 5])
def test_torch_decoder_embedding_adds_learned_positions(dtype, start):
    jcfg, tcfg = _configs(dtype)
    jp, tp = _params(jcfg, tcfg, seed=2)
    tok = _tokens(3, (2, PROMPT), tcfg.vocab_size)
    x, pos = twhisper._embed_dec(tp, torch.from_numpy(tok).long(), tcfg,
                                 start)
    jx, jpos = jwhisper._embed_dec(jp, jnp.asarray(tok), jcfg, start)
    assert x.dtype == getattr(torch, dtype)
    _close(x, jx, TOL[dtype])
    assert np.array_equal(pos.numpy(), np.asarray(jpos))


# -- the encoder and cross-attention ------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_encode_matches_the_reference(dtype):
    """Frames in fp32 (cast to the activation dtype, as the reference
    casts), 3 encoder layers of non-causal self-attention."""
    jcfg, tcfg = _configs(dtype, encoder_layers=3)
    jp, tp = _params(jcfg, tcfg, seed=4)
    frames = _normal(5, (2, tcfg.encoder_seq, tcfg.d_model))
    out = twhisper.encode(tp, torch.from_numpy(frames), tcfg)
    jout = jwhisper.encode(jp, jnp.asarray(frames), jcfg)
    assert out.dtype == getattr(torch, dtype)
    _close(out, jout, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_cross_attention_matches_the_reference(dtype):
    """A cross call with ``kv_source`` (prompt of 7 queries against 12
    encoder positions): output and the projected K/V it returns; then a
    call with those K/V as ``precomputed_kv`` (one decode query at
    position 9): the same output as the reference's."""
    jcfg, tcfg = _configs(dtype)
    jp, _ = jattn.init_attention(jax.random.PRNGKey(6), jcfg,
                                 jnp.dtype(dtype))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    B, T, D = 2, tcfg.encoder_seq, tcfg.d_model
    x, enc = _normal(7, (B, PROMPT, D)), _normal(8, (B, T, D))
    pos = np.broadcast_to(np.arange(PROMPT), (B, PROMPT))
    out, kv = tattn.attention_layer(_t(x, dtype), tp, tcfg, _t(pos).long(),
                                    kv_source=_t(enc, dtype))
    jout, jkv = jattn.attention_layer(
        jnp.asarray(x, dtype), jp, jcfg, jnp.asarray(pos),
        kv_source=jnp.asarray(enc, dtype))
    _close(out, jout, TOL[dtype])
    for name in ("k", "v"):
        assert tuple(kv[name].shape) == (B, T, tcfg.num_kv_heads,
                                         tcfg.resolved_head_dim)
        _close(kv[name], jkv[name], TOL[dtype])
    q1, p1 = _normal(9, (B, 1, D)), np.full((B, 1), 9)
    out1, kv1 = tattn.attention_layer(
        _t(q1, dtype), tp, tcfg, _t(p1).long(),
        precomputed_kv=(kv["k"], kv["v"]))
    jout1, _ = jattn.attention_layer(
        jnp.asarray(q1, dtype), jp, jcfg, jnp.asarray(p1),
        precomputed_kv=(jkv["k"], jkv["v"]))
    _close(out1, jout1, TOL[dtype])
    assert kv1["k"] is kv["k"]


def test_torch_learned_positions_turn_no_rope():
    """whisper's self-attention (learned positions) applies no RoPE, as
    the reference's; a RoPE config on the same weights and inputs
    differs."""
    jcfg, tcfg = _configs()
    jp, _ = jattn.init_attention(jax.random.PRNGKey(10), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    x = _normal(11, (2, PROMPT, tcfg.d_model))
    pos = np.broadcast_to(np.arange(3, 3 + PROMPT), (2, PROMPT))
    out, _ = tattn.attention_layer(_t(x), tp, tcfg, _t(pos).long())
    jout, _ = jattn.attention_layer(jnp.asarray(x), jp, jcfg,
                                    jnp.asarray(pos))
    _close(out, jout, TOL["float32"])
    roped, _ = tattn.attention_layer(_t(x), tp,
                                     tcfg.replace(pos_embedding="rope"),
                                     _t(pos).long())
    assert float((roped - out).abs().max()) > 1e-3


def test_torch_only_the_decoders_causal_prefill_would_take_flash(
        monkeypatch):
    """Every ``attention_core`` call of a prefill and a decode step, by
    kind: the encoder's and every cross call are non-causal (naive in both
    packages); the decoder's self-attention prefill is the one causal call
    with Sq > 1 a layer, the call the flash kernel takes on the card."""
    _, tcfg = _configs(encoder_layers=3)
    params = twhisper.init(torch.Generator().manual_seed(12), tcfg)
    calls = []
    core = tattn.attention_core

    def recording(q, k, v, qpos, kpos, config, causal=True, window=0):
        calls.append((causal, q.shape[1], k.shape[1]))
        return core(q, k, v, qpos, kpos, config, causal, window)

    monkeypatch.setattr(tattn, "attention_core", recording)
    T = tcfg.encoder_seq
    batch = {"tokens": torch.from_numpy(_tokens(13, (2, PROMPT), 256)).long(),
             "frames": torch.from_numpy(_normal(14, (2, T, 64)))}
    _, cache = twhisper.prefill(params, batch, tcfg, max_len=PROMPT + 1)
    enc, dec = 3 * [(False, T, T)], [(True, PROMPT, PROMPT),
                                     (False, PROMPT, T)] * 2
    assert calls == enc + dec
    calls.clear()
    twhisper.decode_step(params, batch["tokens"][:, :1], cache, tcfg)
    assert calls == [(True, 1, PROMPT + 1), (False, 1, T)] * 2


# -- prefill and decode -------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_prefill_then_decode_matches_jax(dtype):
    """Prefill of a 7-token prompt over 12 frames into a cache of 10 slots,
    then three decode steps: every step's logits and every cache leaf
    (self K/V, cross K/V, pos) against the reference's."""
    jcfg, tcfg = _configs(dtype, encoder_layers=3)
    jp, tp = _params(jcfg, tcfg, seed=3)
    B, steps = 2, 3
    tok = _tokens(15, (B, PROMPT), tcfg.vocab_size)
    frames = _normal(16, (B, tcfg.encoder_seq, tcfg.d_model))
    jl, jc = _jprefill(jp, {"tokens": jnp.asarray(tok),
                            "frames": jnp.asarray(frames)}, jcfg,
                       PROMPT + steps)
    tl, tc = twhisper.prefill(tp, {"tokens": torch.from_numpy(tok).long(),
                                   "frames": torch.from_numpy(frames)},
                              tcfg, max_len=PROMPT + steps)

    def same_cache():
        for name in ("self_k", "self_v", "cross_k", "cross_v"):
            assert tuple(tc[name].shape) == jc[name].shape, name
            assert tc[name].dtype == getattr(torch, dtype)
            _close(tc[name], jc[name], TOL[dtype])
        assert tc["pos"] == int(jc["pos"])

    _close(tl, jl, TOL[dtype])
    same_cache()
    for i in range(steps):
        nxt = _tokens(17 + i, (B, 1), tcfg.vocab_size)
        jl, jc = _jdecode(jp, jnp.asarray(nxt), jc, jcfg)
        tl, tc = twhisper.decode_step(tp, torch.from_numpy(nxt).long(), tc,
                                      tcfg)
        _close(tl, jl, TOL[dtype])
        same_cache()
    assert tc["pos"] == PROMPT + steps


def test_torch_whisper_serve_invariant():
    """The port's counterpart of tests/test_models.py::test_prefill_then_
    decode_matches_full_forward for whisper-medium: greedy prefill +
    decode over the same frames equals the argmax of teacher-forced
    prefills, in fp32."""
    _, tcfg = _configs()
    params = twhisper.init(torch.Generator().manual_seed(1), tcfg)
    B, S, G = 2, 12, 4
    tok = torch.from_numpy(_tokens(18, (B, S), tcfg.vocab_size)).long()
    frames = torch.from_numpy(_normal(19, (B, tcfg.encoder_seq,
                                           tcfg.d_model)))
    logits, cache = twhisper.prefill(params, {"tokens": tok,
                                              "frames": frames}, tcfg,
                                     max_len=S + G)
    serve = [logits[:, -1].argmax(-1)]
    for _ in range(G - 1):
        logits, cache = twhisper.decode_step(params, serve[-1][:, None],
                                             cache, tcfg)
        serve.append(logits[:, -1].argmax(-1))
    full = tok
    for g in range(G):
        forced, _ = twhisper.prefill(params, {"tokens": full,
                                              "frames": frames}, tcfg,
                                     max_len=full.shape[1] + 1)
        nxt = forced[:, -1].argmax(-1)
        assert torch.equal(nxt, serve[g]), g
        full = torch.cat([full, nxt[:, None]], dim=1)


# -- conversion and serving ------------------------------------------------------------
def test_torch_converted_whisper_stacks_keep_their_depths():
    """3 encoder and 2 decoder layers: each stack unstacked on its own
    depth, each layer the reference's slice; a config with the depths
    swapped is refused."""
    jcfg, tcfg = _configs("bfloat16", encoder_layers=3)
    jp, tp = _params(jcfg, tcfg)
    assert len(tp["encoder"]) == 3 and len(tp["decoder"]) == 2
    assert torch.equal(tp["encoder"][2]["attn"]["wq"], tensor_from_numpy(
        np.asarray(jp["encoder"]["attn"]["wq"][2])))
    assert torch.equal(tp["decoder"][1]["cross_attn"]["wv"],
                       tensor_from_numpy(np.asarray(
                           jp["decoder"]["cross_attn"]["wv"][1])))
    assert torch.equal(tp["enc_pos"], tensor_from_numpy(
        np.asarray(jp["enc_pos"])))
    assert torch.equal(tp["embed"]["pos"], tensor_from_numpy(
        np.asarray(jp["embed"]["pos"])))
    assert tp["dec_norm"]["bias"].dtype == torch.bfloat16
    swapped = tcfg.replace(encoder_layers=2, num_layers=3)
    with pytest.raises(ValueError, match="stacked over"):
        params_from_jax(jax.tree_util.tree_map(np.asarray, jp), swapped)


def test_torch_serve_whisper_matches_the_jax_model_with_its_frames(
        monkeypatch):
    """The reference's serve sends tokens only, so its whisper prefill
    raises ``KeyError: 'frames'``; ``run_serve --arch whisper-medium
    --reduced`` sends each request's frames (drawn right after its prompt)
    and, on the reference's weights in fp32, gives the reference model's
    greedy tokens over the same frames, batch by batch, with no kernel
    launched on the CPU."""
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", ARCH, "--requests", "2", "--batch", "2",
        "--prompt-len", str(PROMPT), "--gen", "2"])
    with pytest.raises(KeyError, match="frames"):
        jserve.main()

    args = parse_args(["--arch", ARCH, "--reduced", "--requests", "6",
                       "--batch", "4", "--prompt-len", str(PROMPT), "--gen",
                       "5", "--seed", "5"])
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg, seed=2)
    res = run_serve(args, device="cpu", params=tp, config=tcfg)
    assert set(res["launches"].values()) == {0}
    rng = np.random.default_rng(args.seed)
    reqs = []
    for _ in range(args.requests):
        prompt = rng.integers(0, jcfg.vocab_size, (args.prompt_len,),
                              dtype=np.int32)
        frames = rng.standard_normal(
            (jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
        reqs.append((prompt, frames))
    for lo in range(0, args.requests, args.batch):
        batch = reqs[lo:lo + args.batch]
        batch += [batch[-1]] * (args.batch - len(batch))
        logits, cache = _jprefill(
            jp, {"tokens": jnp.asarray(np.stack([p for p, _ in batch])),
                 "frames": jnp.asarray(np.stack([f for _, f in batch]))},
            jcfg, args.prompt_len + args.gen)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        outs = [np.asarray(tok)[:, 0]]
        for _ in range(args.gen - 1):
            logits, cache = _jdecode(jp, tok, cache, jcfg)
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            outs.append(np.asarray(tok)[:, 0])
        want = np.stack(outs, axis=1)
        for i in range(min(args.batch, args.requests - lo)):
            assert res["results"][lo + i] == want[i].tolist(), lo + i
