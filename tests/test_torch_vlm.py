"""The port's VLM family (llava-next-34b) against the reference, on the
CPU: the config, the image prefix in ``_embed_inputs``, ``prefill`` and
``decode_step`` with ``image_embeds`` in fp32 and bf16, the serve
invariant behind the image prefix, the training loss's image-prefix
shift with a loss mask, its 5-step loss curve, and ``run_serve --arch
llava-next-34b --reduced`` against the reference model's greedy tokens
over the same images.

The same weights (the reference's random init, converted by
``repro_torch.models.convert``) and the same numpy inputs go through
``repro`` and ``repro_torch``. Tolerances as tests/test_torch_models.py:
fp32 1e-5, bf16 2e-2 of the largest magnitude compared; the loss curve
1e-4 relative (tests/test_torch_training.py says why).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtransformer
from repro_torch.configs import ARCHS, WAITING, get_config
from repro_torch.launch.serve import parse_args, run_serve
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model
from repro_torch.training import loss_and_grads
from repro_torch.utils import tree_params
from tests.test_torch_optim import CURVE_TOL, loss_curves
from tests.test_torch_training import (_jbatch, _loss_and_grads,
                                       _close_leaves, _tbatch)

ARCH = "llava-next-34b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the reference's init at full width, counted by jax.eval_shape: 60 layers
# of 557,856,768, the embedding and the untied head of 458,752,000 each,
# and the final norm's 7,168
FULL_PARAMS = 34_388_917_248

_jprefill = jax.jit(jtransformer.prefill, static_argnums=(2, 3))
_jdecode = jax.jit(jtransformer.decode_step, static_argnums=3)


def _configs(dtype="float32", **kw):
    kw = dict(dtype=dtype, param_dtype=dtype, **kw)
    return (jax_get_config(ARCH, reduced=True).replace(**kw),
            get_config(ARCH, reduced=True).replace(**kw))


def _params(jcfg, tcfg, seed=0):
    jp = jtransformer.init(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)


def _inputs(cfg, seed, b, s):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s),
                                   dtype=np.int32),
            "image_embeds": rng.standard_normal(
                (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)}


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if tol > 1e-3 else 1.0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * scale)


# -- the config ------------------------------------------------------------------------
def test_torch_llava_config_has_the_reference_numbers():
    """Every field the port shares with the reference holds its value at
    the full config and at reduced(); the family is served by the
    transformer; the full model has the reference's parameter count."""
    assert ARCH in ARCHS and ARCH not in WAITING
    for reduced in (False, True):
        jcfg = jax_get_config(ARCH, reduced=reduced)
        tcfg = get_config(ARCH, reduced=reduced)
        for f in ("name", "family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "d_ff", "vocab_size", "head_dim",
                  "hidden_act", "mlp_gated", "norm", "rope_theta",
                  "tie_embeddings", "num_image_tokens", "remat", "dtype",
                  "param_dtype", "pos_embedding"):
            assert getattr(tcfg, f) == getattr(jcfg, f), (reduced, f)
        assert get_model(tcfg) is ttransformer
    shapes = jax.eval_shape(lambda: jtransformer.init(
        jax.random.PRNGKey(0), jax_get_config(ARCH)))
    assert sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes)) == FULL_PARAMS
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    assert tree_params(tp) == sum(int(np.prod(np.shape(x))) for x in
                                  jax.tree_util.tree_leaves(jp))


# -- the image prefix ------------------------------------------------------------------
def test_torch_embed_inputs_prepends_the_image_prefix():
    """The image embeddings cast to the activation dtype, then the token
    embeddings; positions over the whole sequence; decode positions after
    it."""
    jcfg, tcfg = _configs("bfloat16")
    jp, tp = _params(jcfg, tcfg)
    batch = _inputs(tcfg, 1, 2, 5)
    jx, jpos = jtransformer._embed_inputs(jp, _jbatch(batch), jcfg)
    tx, tpos = ttransformer._embed_inputs(tp, _tbatch(batch), tcfg)
    n = tcfg.num_image_tokens
    assert tx.shape == (2, n + 5, tcfg.d_model) and tx.dtype == torch.bfloat16
    assert torch.equal(tx[:, :n], torch.from_numpy(
        batch["image_embeds"]).to(torch.bfloat16))
    _close(tx, np.asarray(jx, np.float32), 0.0)
    assert tpos.tolist() == np.asarray(jpos).tolist()
    _, dpos = ttransformer._embed_inputs(
        tp, {"tokens": torch.zeros((2, 1), dtype=torch.long)}, tcfg,
        start_pos=n + 5)
    assert dpos.tolist() == [[n + 5]] * 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_vlm_prefill_and_decode_match_jax(dtype):
    """Prefill of 2 x 7 tokens behind 4 image embeddings (logits and the
    whole cache), then three decode steps, against the reference."""
    jcfg, tcfg = _configs(dtype)
    jp, tp = _params(jcfg, tcfg, seed=2)
    B, S, G = 2, 7, 3
    batch = _inputs(tcfg, 3, B, S)
    max_len = tcfg.num_image_tokens + S + G
    jl, jc = _jprefill(jp, _jbatch(batch), jcfg, max_len)
    with torch.inference_mode():
        tl, tc = ttransformer.prefill(tp, _tbatch(batch), tcfg,
                                      max_len=max_len)
        _close(tl, jl, TOL[dtype])
        for name in ("k", "v"):
            _close(tc[name], jc[name], TOL[dtype])
        assert tc["pos"] == int(jc["pos"]) == tcfg.num_image_tokens + S
        rng = np.random.default_rng(4)
        for _ in range(G):
            nxt = rng.integers(0, tcfg.vocab_size, (B, 1), dtype=np.int32)
            jl, jc = _jdecode(jp, jnp.asarray(nxt), jc, jcfg)
            tl, tc = ttransformer.decode_step(
                tp, torch.from_numpy(nxt).long(), tc, tcfg)
            _close(tl, jl, TOL[dtype])
    for name in ("k", "v"):
        _close(tc[name], jc[name], TOL[dtype])


def test_torch_vlm_serve_invariant():
    """Greedy prefill + decode behind the image prefix equals the argmax
    of teacher-forced prefills over the same images, in fp32."""
    _, tcfg = _configs()
    params = ttransformer.init(torch.Generator().manual_seed(1), tcfg)
    B, S, G = 2, 9, 4
    batch = _tbatch(_inputs(tcfg, 5, B, S))
    n = tcfg.num_image_tokens
    with torch.inference_mode():
        logits, cache = ttransformer.prefill(params, batch, tcfg,
                                             max_len=n + S + G)
        serve = [logits[:, -1].argmax(-1)]
        for _ in range(G - 1):
            logits, cache = ttransformer.decode_step(
                params, serve[-1][:, None], cache, tcfg)
            serve.append(logits[:, -1].argmax(-1))
        full = batch["tokens"]
        for g in range(G):
            forced, _ = ttransformer.prefill(
                params, {**batch, "tokens": full}, tcfg,
                max_len=n + full.shape[1] + 1)
            nxt = forced[:, -1].argmax(-1)
            assert torch.equal(nxt, serve[g]), g
            full = torch.cat([full, nxt[:, None]], dim=1)


# -- the training loss -----------------------------------------------------------------
def test_torch_vlm_loss_with_a_mask_matches_jax():
    """The image-prefix shift: the last image position predicts the first
    token, every text token is a target, and a (B, S) loss mask is taken
    unshifted; loss and gradients in fp32 against ``jax.value_and_grad``
    (1e-5; gradients 1e-4 of each leaf's largest magnitude)."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg, seed=6)
    batch = _inputs(tcfg, 7, 2, 10)
    batch["loss_mask"] = (np.random.default_rng(8).uniform(size=(2, 10))
                          > 0.3).astype(np.float32)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jtransformer.loss_and_metrics(p, _jbatch(batch), jcfg),
        has_aux=True)(jp)
    tl, _, tg = loss_and_grads(tp, _tbatch(batch),
                               tcfg.replace(attention_impl="naive"))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _close_leaves(tg, params_from_jax(jax.tree_util.tree_map(np.asarray, jg),
                                      tcfg), 1e-4)
    x = torch.zeros((2, tcfg.num_image_tokens + 10, 3))
    pred, targets, mask = ttransformer.next_token_targets(x, _tbatch(batch))
    assert pred.shape[1] == targets.shape[1] == mask.shape[1] == 10


def test_torch_vlm_loss_and_grads_match_jax():
    """``loss_and_metrics`` at reduced() in fp32 behind the image prefix."""
    (jl, _, jg), (tl, _, tg) = _loss_and_grads(ARCH, "float32")
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _close_leaves(tg, jg, 1e-4)


def test_torch_vlm_loss_curve_matches_jax():
    """Five fp32 train steps over image-prefixed batches against the
    reference's."""
    got, want = loss_curves(ARCH)
    np.testing.assert_allclose(got, want, rtol=CURVE_TOL)


# -- serving ---------------------------------------------------------------------------
def test_torch_serve_llava_matches_the_jax_model_with_its_images():
    """``run_serve --arch llava-next-34b --reduced`` draws each request's
    image embeddings right after its prompt, sizes the cache for the
    prefix, and, on the reference's weights in fp32, gives the reference
    model's greedy tokens over the same images, batch by batch, with no
    kernel launched on the CPU."""
    args = parse_args(["--arch", ARCH, "--reduced", "--requests", "6",
                       "--batch", "4", "--prompt-len", "7", "--gen", "5",
                       "--seed", "5"])
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg, seed=2)
    res = run_serve(args, device="cpu", params=tp, config=tcfg)
    assert set(res["launches"].values()) == {0}
    rng = np.random.default_rng(args.seed)
    reqs = []
    for _ in range(args.requests):
        prompt = rng.integers(0, jcfg.vocab_size, (args.prompt_len,),
                              dtype=np.int32)
        image = rng.standard_normal(
            (jcfg.num_image_tokens, jcfg.d_model)).astype(np.float32)
        reqs.append((prompt, image))
    for lo in range(0, args.requests, args.batch):
        batch = reqs[lo:lo + args.batch]
        batch += [batch[-1]] * (args.batch - len(batch))
        logits, cache = _jprefill(
            jp, {"tokens": jnp.asarray(np.stack([p for p, _ in batch])),
                 "image_embeds": jnp.asarray(np.stack([i for _, i in batch]))},
            jcfg, jcfg.num_image_tokens + args.prompt_len + args.gen)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        outs = [np.asarray(tok)[:, 0]]
        for _ in range(args.gen - 1):
            logits, cache = _jdecode(jp, tok, cache, jcfg)
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            outs.append(np.asarray(tok)[:, 0])
        want = np.stack(outs, axis=1)
        for i in range(min(args.batch, args.requests - lo)):
            assert res["results"][lo + i] == want[i].tolist(), lo + i
