"""The port's training loss against the reference, on the CPU: the
cross-entropy and ``_chunked_ce``, ``loss_and_metrics`` and its gradients
for every ported arch, the chunked WKV's gradient, the flash wrapper's
refusal under autograd, and the train step's attention schedule. The loss
curves and AdamW are in tests/test_torch_optim.py, the train loop in
tests/test_torch_train_loop.py, the VLM family in tests/test_torch_vlm.py.

The same weights (the reference's random init, converted by
``repro_torch.models.convert``) and the same numpy inputs go through
``repro`` and ``repro_torch``. Both train on ``attention_impl="blocked"``
(the naive function in tiles; the port's default ``flash`` trains as
``blocked``), which at these lengths, under ``attention_block_q``,
dispatches to the naive attention; tests/test_torch_attention_schedules.py
runs the tiles. Tolerances, fp32: the loss within 1e-5
relative; each gradient leaf within 1e-4 of that leaf's largest magnitude
(the backward pass sums over the batch and the sequence in another
order); a 5-step loss curve within 1e-4 relative (AdamW's first steps
move a parameter by about lr · sign(g), so gradients near zero may step
differently; the loss, not the parameters, is held). bf16: the loss
within 2e-2 relative and each gradient leaf within 0.1 of its largest
magnitude (the two frameworks round activations at different places; a
bf16 step is 2^-8 of a value, and the backward pass compounds it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.registry import get_model as jax_get_model
from repro_torch.configs import REFERENCE_ARCHS, get_config
from repro_torch.configs.base import OptimizerConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers as tlayers
from repro_torch.models import rwkv6 as trwkv6
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model
from repro_torch.training import (build_train_step, init_state,
                                  loss_and_grads)
from repro_torch.utils import tree_leaves

LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 0.1}
B, S = 2, 12


def _configs(arch, dtype="float32", **kw):
    kw = dict(dtype=dtype, param_dtype=dtype, **kw)
    return (jax_get_config(arch, reduced=True).replace(**kw),
            get_config(arch, reduced=True).replace(**kw))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, seed, b=B, s=S):
    """Tokens, and the family's stub embeddings, as numpy arrays."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s),
                                    dtype=np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v)
            for k, v in batch.items()}


def _close_leaves(got_tree, want_tree, tol):
    """Each leaf within ``tol`` of that leaf's largest magnitude."""
    got, want = tree_leaves(got_tree), tree_leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = w.float().numpy()
        g = g.float().numpy()
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale)


# -- the loss functions --------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_torch_cross_entropy_matches_jax(masked, z_loss):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 9, 50)) * 3).astype(np.float32)
    targets = rng.integers(0, 50, (3, 9), dtype=np.int32)
    mask = (rng.uniform(size=(3, 9)) > 0.3).astype(np.float32)
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                 jnp.asarray(mask) if masked else None,
                                 z_loss)
    got = tlayers.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(targets).long(),
                                torch.from_numpy(mask) if masked else None,
                                z_loss)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_torch_chunked_ce_matches_direct():
    """The counterpart of tests/test_models.py::test_chunked_ce_matches_
    direct (chunk 7 over 25 positions: a padded last chunk), held to the
    port's direct cross-entropy (1e-4, the reference's tolerance) and to
    the reference's ``_chunked_ce`` (1e-6)."""
    jcfg, tcfg = _configs("internlm2-1.8b")
    jp = jtransformer.init(jax.random.PRNGKey(10), jcfg)
    tp = params_from_jax(_np(jp), tcfg)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 25, tcfg.d_model)).astype(np.float32)
    targets = rng.integers(0, tcfg.vocab_size, (3, 25), dtype=np.int32)
    mask = (rng.uniform(size=(3, 25)) > 0.2).astype(np.float32)
    got = ttransformer._chunked_ce(torch.from_numpy(x), tp, tcfg,
                                   torch.from_numpy(targets).long(),
                                   torch.from_numpy(mask), chunk=7)
    logits = tlayers.lm_logits(torch.from_numpy(x), tp["embed"], tcfg)
    direct = tlayers.cross_entropy(logits, torch.from_numpy(targets).long(),
                                   torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(direct), rtol=1e-4)
    want = jtransformer._chunked_ce(jnp.asarray(x), jp, jcfg,
                                    jnp.asarray(targets), jnp.asarray(mask),
                                    chunk=7)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_torch_chunked_ce_gradient_matches_jax():
    """Through the checkpointed chunks, the gradient with respect to the
    hidden states and the head."""
    jcfg, tcfg = _configs("internlm2-1.8b")
    jp = jtransformer.init(jax.random.PRNGKey(12), jcfg)
    tp = params_from_jax(_np(jp), tcfg)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 19, tcfg.d_model)).astype(np.float32)
    targets = rng.integers(0, tcfg.vocab_size, (2, 19), dtype=np.int32)
    mask = np.ones((2, 19), np.float32)

    def jloss(x, head):
        p = {**jp, "embed": {**jp["embed"], "lm_head": head}}
        return jtransformer._chunked_ce(x, p, jcfg, jnp.asarray(targets),
                                        jnp.asarray(mask), chunk=8)

    jgx, jgh = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jp["embed"]["lm_head"])
    tx = torch.from_numpy(x).requires_grad_()
    head = tp["embed"]["lm_head"].clone().requires_grad_()
    p = {**tp, "embed": {**tp["embed"], "lm_head": head}}
    loss = ttransformer._chunked_ce(tx, p, tcfg,
                                    torch.from_numpy(targets).long(),
                                    torch.from_numpy(mask), chunk=8)
    gx, gh = torch.autograd.grad(loss, (tx, head))
    _close_leaves([gx, gh], [torch.from_numpy(np.array(jgx)),
                             torch.from_numpy(np.array(jgh))], 1e-4)


# -- loss_and_metrics and its gradients, every ported arch -----------------------------
def _loss_and_grads(arch, dtype, seed=0):
    jcfg, tcfg = _configs(arch, dtype)
    jmodel = jax_get_model(jcfg)
    jp = jmodel.init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(_np(jp), tcfg)
    batch = _batch(tcfg, seed + 1)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_and_metrics(p, _jbatch(batch), jcfg),
        has_aux=True))(jp)
    tcfg = tcfg.replace(attention_impl="naive")
    tl, tm, tg = loss_and_grads(tp, _tbatch(batch), tcfg)
    return (jl, jm, params_from_jax(_np(jg), tcfg)), (tl, tm, tg)


@pytest.mark.parametrize("arch", sorted(REFERENCE_ARCHS))
def test_torch_loss_and_grads_match_jax(arch):
    """fp32 at reduced(): the total loss, the cross-entropy, the aux loss
    and every gradient leaf against ``jax.value_and_grad``."""
    (jl, jm, jg), (tl, tm, tg) = _loss_and_grads(arch, "float32")
    for got, want in ((tl, jl), (tm["loss"], jm["loss"])):
        np.testing.assert_allclose(float(got), float(want),
                                   rtol=LOSS_TOL["float32"])
    np.testing.assert_allclose(float(tm["aux_loss"]),
                               float(jm["aux_loss"]),
                               rtol=1e-5, atol=1e-7)
    _close_leaves(tg, jg, GRAD_TOL["float32"])


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "llava-next-34b"])
def test_torch_loss_and_grads_match_jax_in_bf16(arch):
    (jl, _, jg), (tl, _, tg) = _loss_and_grads(arch, "bfloat16", seed=3)
    np.testing.assert_allclose(float(tl), float(jl),
                               rtol=LOSS_TOL["bfloat16"])
    _close_leaves(tg, jg, GRAD_TOL["bfloat16"])


# -- the chunked WKV under autograd -----------------------------------------------------
def _wkv_inputs(logw_value=None, seed=5):
    rng = np.random.default_rng(seed)
    Bw, T, H, K = 1, 16, 2, 4
    r, k, v = (torch.from_numpy(rng.standard_normal((Bw, T, H, K)).astype(
        np.float32)) for _ in range(3))
    if logw_value is None:
        logw = -torch.from_numpy(np.exp(rng.standard_normal(
            (Bw, T, H, K))).astype(np.float32))
    else:
        logw = torch.full((Bw, T, H, K), logw_value)
    u = torch.from_numpy(rng.standard_normal((H, K)).astype(np.float32))
    return [t.requires_grad_() for t in (r, k, v, logw, u)]


@pytest.mark.parametrize("logw_value", [None, -150.0])
def test_torch_rwkv_chunked_gradient_equals_the_recurrent_one(logw_value):
    """At w = e^-150 (the reference's extreme-decay case: the pairwise
    differences above the diagonal reach +2,250) and at ordinary decays,
    the chunked WKV's output and gradients are finite and equal the
    recurrent form's (1e-4, the reference's extreme-decay tolerance)."""
    inputs = _wkv_inputs(logw_value)
    outs = {}
    for name, fn in (("chunked", lambda *a: trwkv6._wkv_chunked(*a,
                                                                 chunk=8)),
                     ("recurrent", trwkv6._wkv_recurrent)):
        state = torch.zeros((1, 2, 4, 4))
        y, s = fn(*inputs, state)
        gy = torch.linspace(-1, 1, y.numel()).reshape(y.shape)
        grads = torch.autograd.grad((y * gy).sum() + s.sum(), inputs)
        for g in grads:
            assert torch.isfinite(g).all(), name
        assert torch.isfinite(y).all()
        outs[name] = (y, grads)
    np.testing.assert_allclose(outs["chunked"][0].detach().numpy(),
                               outs["recurrent"][0].detach().numpy(),
                               rtol=1e-4, atol=1e-4)
    for g, w in zip(outs["chunked"][1], outs["recurrent"][1]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("logw_value", [None, -150.0])
def test_torch_rwkv_chunked_serve_form_equals_the_autograd_form(logw_value):
    """The in-place form (grad off, the serve path) and the out-of-place
    form (grad on) compute the same coefficients, bit for bit."""
    r, k, v, logw, u = (t.detach() for t in _wkv_inputs(logw_value))
    state = torch.zeros((1, 2, 4, 4))
    with torch.no_grad():
        y0, s0 = trwkv6._wkv_chunked(r, k, v, logw, u, state, chunk=8)
    y1, s1 = trwkv6._wkv_chunked(r, k, v, logw, u.requires_grad_(), state,
                                 chunk=8)
    assert y1.requires_grad
    assert torch.equal(y0, y1.detach()) and torch.equal(s0, s1.detach())


# -- the flash kernel under autograd ------------------------------------------------------
@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_torch_flash_refuses_inputs_that_require_grad(which):
    """The kernel has no backward pass, so asking for it while autograd
    records raises before dispatch (the refusal's own message, not the
    device check that would follow it); nothing drops a gradient."""
    q, k, v = (torch.zeros((1, 8, 2, 16)) for _ in range(3))
    {"q": q, "k": k, "v": v}[which].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward pass"):
        fa_ops.flash_attention(q, k, v, use_kernel=True)
    assert fa_ops.NO_BACKWARD.startswith("flash_attention: the kernel has "
                                         "no backward pass")


def test_torch_train_step_runs_the_naive_attention():
    """The step's model config is the reference's default schedule,
    ``blocked``, for the port's default ``flash``, which has no backward:
    on the card no flash launch; at these 12 tokens, under
    ``attention_block_q``, the dispatch computes it naive, as the
    reference's does."""
    _, tcfg = _configs("internlm2-1.8b")
    assert tcfg.attention_impl == "flash"
    seen = []
    model = get_model(tcfg)
    real = model.loss_and_metrics

    def spy(params, batch, config):
        seen.append(config.attention_impl)
        return real(params, batch, config)

    opt = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=40,
                          zero1=False)
    state = init_state(torch.Generator().manual_seed(0), tcfg, opt)
    model.loss_and_metrics = spy
    try:
        _, metrics = build_train_step(tcfg, opt)(
            state, _tbatch(_batch(tcfg, 1)))
    finally:
        model.loss_and_metrics = real
    assert seen == ["blocked"]
    assert set(metrics) == {"loss", "aux_loss", "lr", "grad_norm",
                            "total_loss"}


