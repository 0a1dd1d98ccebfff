"""mellum2-12b-a2.5b, a configuration of the port alone, held to its plain
reference (``port_bench/reference/mellum2.py``) at ``reduced()`` on the
CPU, on weights the reference draws from a seed, everything in fp32.

The tolerance, 2e-5 of the largest reference logit, is fp32 round-off
over four layers taken in another order (the program's tiled online
softmax and sorted expert rows against the reference's full rows and
expert-by-expert sums); routing is compared decision for decision, and a
near-tie flip would show as a gap of the logits' own size, not as
round-off.
"""
import numpy as np
import pytest
import torch

from port_bench.drivers.serve_mellum_stream import KINDS, to_tree
from port_bench.reference import mellum2
from port_bench.reference.decoder import Matmul
from repro_torch.configs import ARCHS, REFERENCE_ARCHS, get_config
from repro_torch.configs.base import Yarn
from repro_torch.data.metrics import get_registry
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer
from repro_torch.training import build_serve_fns

ARCH = "mellum2-12b-a2.5b"
TOL = 2e-5
SEED = 2147483647 + 12


def _published(cfg) -> dict:
    """The published config's keys, as the reference reads them, for a
    program config."""
    inv = {v: k for k, v in KINDS.items()}
    y = cfg.full_rope
    return {
        "hidden_size": cfg.d_model, "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "num_hidden_layers": cfg.num_layers,
        "layer_types": [inv[k] for k in transformer.layer_kinds(cfg)],
        "sliding_window": cfg.local_window, "num_experts": cfg.num_experts,
        "num_experts_per_tok": cfg.experts_per_token,
        "moe_intermediate_size": cfg.d_ff, "norm_topk_prob": True,
        "rms_norm_eps": 1e-6, "vocab_size": cfg.vocab_size,
        "rope_parameters": {
            "full_attention": {
                "rope_type": "yarn", "rope_theta": cfg.rope_theta,
                "factor": y.factor,
                "original_max_position_embeddings": y.original_max_position,
                "beta_fast": y.beta_fast, "beta_slow": y.beta_slow,
                "attention_factor": y.attention_factor},
            "sliding_attention": {"rope_type": "default",
                                  "rope_theta": cfg.rope_theta}}}


@pytest.fixture(scope="module")
def model():
    """(program config in fp32, published dict, fp32 leaves, the tree)."""
    cfg = get_config(ARCH, reduced=True).replace(dtype="float32",
                                                 param_dtype="float32")
    c = _published(cfg)
    w = {n: t.float() for n, t in mellum2.draw(c, SEED, "cpu").items()}
    return cfg, c, w, to_tree(w, cfg.num_layers)


def _tokens(n: int, S: int, seed: int = 0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (n, S))).long()


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TOL * scale


def test_torch_mellum2_config_is_the_published_one():
    cfg = get_config(ARCH)
    assert ARCH in ARCHS and ARCH not in REFERENCE_ARCHS
    kinds = transformer.layer_kinds(cfg)
    assert kinds.count("sliding") == 21 and kinds.count("full") == 7
    assert [i for i, k in enumerate(kinds) if k == "full"] == \
        list(range(3, 28, 4))
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.num_experts, cfg.experts_per_token,
            cfg.vocab_size, cfg.local_window) == \
        (2304, 32, 4, 128, 896, 64, 8, 98304, 1024)
    assert cfg.full_rope == Yarn(16.0, 8192, 32.0, 1.0, 1.2772588722239782)
    assert cfg.moe_dropless and not cfg.tie_embeddings
    small = get_config(ARCH, reduced=True)
    assert transformer.layer_kinds(small) == ["sliding"] * 3 + ["full"]
    assert small.num_experts > small.experts_per_token
    assert small.full_rope is not None and small.local_window < 24


@pytest.mark.parametrize("S", [6, 24])
def test_torch_mellum2_prefill_logits_match_the_reference(model, monkeypatch,
                                                          S):
    monkeypatch.setattr(moe_lib, "DENSE_TOKENS", 0)     # sorted by expert
    cfg, c, w, tree = model
    toks = _tokens(2, S)
    prefill, _ = build_serve_fns(cfg)
    got, _ = prefill(tree, {"tokens": toks})
    want = mellum2.logits_at(mellum2.parts_of(w), toks, S - 1, c, Matmul())
    _close(got, want)


def test_torch_mellum2_decode_past_the_window_matches_the_reference(
        model, monkeypatch):
    """A prompt of 12 (past the window of 8) prefilled, then 14 tokens
    decoded through the full and the rolling caches, each step's logits
    against the reference's full forward at that position; the prefill's
    experts sorted by expert, the decode's every expert over its two
    tokens."""
    cfg, c, w, tree = model
    toks = _tokens(2, 26, seed=1)
    P = 12
    monkeypatch.setattr(moe_lib, "DENSE_TOKENS", 4)     # 24 sorted, 2 not
    prefill, decode = build_serve_fns(cfg)
    logits, cache = prefill(tree, {"tokens": toks[:, :P]}, max_len=26)
    assert tuple(cache["k"].shape) == (1, 2, 26, 2, 16)
    assert tuple(cache["k_sliding"].shape) == (3, 2, 8, 2, 16)
    got = [logits[:, -1]]
    for t in range(P, 25):
        logits, cache = decode(tree, toks[:, t:t + 1], cache)
        got.append(logits[:, -1])
    want = mellum2.logits_at(mellum2.parts_of(w), toks[:, :25], P - 1, c,
                             Matmul())
    _close(torch.stack(got, dim=1), want)
    assert cache["pos"] == 25


@pytest.mark.parametrize("dense_tokens", [0, 64])
def test_torch_mellum2_dropless_moe_keeps_every_slot(model, monkeypatch,
                                                     dense_tokens):
    """A router forced onto expert 0 (inputs of positive mean against a
    column of 10s) sends every token's first choice there: the dropless
    layer computes all T of its rows, equal to the reference's
    expert-by-expert loop, where the capacity buffer (C = ceil(T·k/E ·
    1.25)) would drop most of them; sorted by expert (``DENSE_TOKENS``
    0) and every expert over every token (64, a decode step's path)."""
    monkeypatch.setattr(moe_lib, "DENSE_TOKENS", dense_tokens)
    cfg, c, w, _ = model
    p = "layers.0."
    lw = {n: t.clone() for n, t in w.items() if n.startswith(p)}
    lw[p + "moe.router"][:, 0] = 10.0
    x = 3.0 + torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                          .manual_seed(3))
    params = to_tree({**w, **lw}, cfg.num_layers)["layers"][0]["moe"]
    reg = get_registry()
    before = reg.counter("moe_rows_total").value()
    got, aux = moe_lib.moe_layer_dropless(x, params, cfg)
    T, K = 32, cfg.experts_per_token
    assert reg.counter("moe_rows_total").value() - before == T * K
    if T > dense_tokens:
        assert reg.gauge("moe_expert_rows_max").value() == T
    _, _, top = moe_lib.route(x.reshape(T, -1), params["router"], K)
    assert bool((top[:, 0] == 0).all())
    assert T > moe_lib.capacity(T, cfg)
    want = mellum2.experts(x.reshape(T, -1), lw, p, c, Matmul())
    _close(got.reshape(T, -1), want)
    assert torch.isfinite(aux)


def test_torch_mellum2_yarn_frequencies_are_the_formula():
    """yarn's inverse frequencies and scale at the published parameters
    (hd 128) and at ``reduced()``'s, against the reference's formula and
    against the ramp worked out by hand: at hd 128, θ 500,000 and 8,192
    pretraining positions the ramp runs from dim 18 (⌊18.08⌋, beta_fast
    32) to dim 35 (⌈34.98⌉, beta_slow 1) of the 64."""
    for cfg in (get_config(ARCH), get_config(ARCH, reduced=True)):
        hd = cfg.head_dim
        got, scale = L.yarn_frequencies(hd, cfg.rope_theta, cfg.full_rope)
        full = _published(cfg)["rope_parameters"]["full_attention"]
        want, want_scale = mellum2.yarn(hd, full)
        assert torch.equal(got, want) and scale == want_scale
    inv, scale = L.yarn_frequencies(128, 500_000.0, get_config(ARCH).full_rope)
    base = 1.0 / 500_000.0 ** (torch.arange(0, 128, 2).float() / 128)
    torch.testing.assert_close(inv[:19], base[:19], rtol=1e-6, atol=0)
    torch.testing.assert_close(inv[35:], base[35:] / 16, rtol=1e-6, atol=0)
    ramp = (torch.arange(18, 35).float() - 18) / 17
    torch.testing.assert_close(
        inv[18:35], base[18:35] / 16 * ramp + base[18:35] * (1 - ramp),
        rtol=1e-6, atol=0)
    assert scale == pytest.approx(0.1 * np.log(16) + 1.0, rel=1e-9)


def test_torch_mellum2_rope_scales_cos_and_sin():
    """``apply_rope`` with yarn turns by yarn's angles and scales the
    vector's length by the attention factor."""
    y = Yarn(4.0, 64, 32.0, 1.0, 1.25)
    x = torch.randn(1, 5, 2, 16)
    pos = torch.arange(5)[None]
    out = L.apply_rope(x, pos, 10_000.0, y)
    torch.testing.assert_close(out.norm(dim=-1), 1.25 * x.norm(dim=-1))
    want = mellum2.rope(x[0], 0, {"rope_type": "yarn", "rope_theta": 1e4,
                                  "factor": 4.0,
                                  "original_max_position_embeddings": 64,
                                  "beta_fast": 32.0, "beta_slow": 1.0,
                                  "attention_factor": 1.25})
    torch.testing.assert_close(out[0], want, rtol=1e-6, atol=1e-6)


def test_torch_internlm2_cache_tree_and_decode_are_unchanged():
    """A model with no attention pattern keeps one stacked cache, 'k', 'v'
    and 'pos', every layer at max_len, and its decode still equals the
    prefill of the longer prompt."""
    cfg = get_config("internlm2-1.8b", reduced=True).replace(
        dtype="float32", param_dtype="float32")
    assert transformer.layer_kinds(cfg) == ["full"] * cfg.num_layers
    cache = transformer.init_cache(cfg, 2, 10, torch.device("cpu"))
    assert sorted(cache) == ["k", "pos", "v"]
    assert tuple(cache["k"].shape) == (cfg.num_layers, 2, 10,
                                       cfg.num_kv_heads, cfg.head_dim)
    assert transformer.cache_specs(cfg) == {
        "k": ("layers", "batch", "null", "kv_heads", "head_dim"),
        "v": ("layers", "batch", "null", "kv_heads", "head_dim"), "pos": ()}
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    toks = _tokens(2, 9, seed=2)
    logits, cache = transformer.prefill(params, {"tokens": toks[:, :6]},
                                        cfg, max_len=9)
    for t in range(6, 9):
        logits, cache = transformer.decode_step(params, toks[:, t:t + 1],
                                                cache, cfg)
        want, _ = transformer.prefill(params, {"tokens": toks[:, :t + 1]},
                                      cfg)
        torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-5)
    assert sorted(cache) == ["k", "pos", "v"] and cache["pos"] == 9


def test_torch_mellum2_cache_bytes_by_kind():
    cfg = get_config(ARCH)
    cache = transformer.init_cache(cfg, 16, 8224, torch.device("meta"))
    reg = get_registry()
    full = reg.gauge("kv_cache_bytes", labels={"kind": "full"}).value()
    sliding = reg.gauge("kv_cache_bytes", labels={"kind": "sliding"}).value()
    assert full == 2 * 7 * 16 * 8224 * 4 * 128 * 2        # 1.89 GB
    assert sliding == 2 * 21 * 16 * 1024 * 4 * 128 * 2    # 0.70 GB
    assert tuple(cache["v_sliding"].shape) == (21, 16, 1024, 4, 128)


def test_torch_mellum2_yarn_equals_transformers():
    """The published parameters through transformers' own
    ``_compute_yarn_parameters``, where the library is installed."""
    rope_utils = pytest.importorskip("transformers.modeling_rope_utils")
    cfg = get_config(ARCH)
    y = cfg.full_rope

    class Published:
        rope_theta = cfg.rope_theta
        hidden_size, num_attention_heads = cfg.d_model, cfg.num_heads
        head_dim = cfg.head_dim
        max_position_embeddings = 131072
        rope_scaling = {"rope_type": "yarn", "factor": y.factor,
                        "original_max_position_embeddings":
                            y.original_max_position,
                        "beta_fast": y.beta_fast, "beta_slow": y.beta_slow,
                        "attention_factor": y.attention_factor}

    want, want_scale = rope_utils._compute_yarn_parameters(Published(),
                                                           "cpu")
    got, scale = L.yarn_frequencies(cfg.head_dim, cfg.rope_theta, y)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert scale == want_scale
