"""The port's tiled attention schedules (``blocked``, ``blocked`` with the
``_skip_blocks`` override, ``triangular``) and its dispatch, against the
JAX package's and against the port's naive attention, on the CPU.

The same numpy-seeded q, k, v (K/V repeated from fewer heads, as GQA
repeats them) go through ``repro.models.attention`` and
``repro_torch.models.attention``: causal and non-causal, window 0 and a
window smaller than a block, Sq that no block divides, and Sq != Skv
(cross). fp32 within 2e-6 of the largest magnitude (the tiles sum in
another order than the naive softmax); bf16 within 2e-2
(tests/test_kernels.py's bf16 tolerance). The gradients through the
tiles against the port's naive attention and ``jax.grad`` of the
reference's ``blocked`` within 1e-5 of the largest magnitude. The
dispatch, branch for branch, against the reference's ``attention_core``
(each module's functions spied on). Prefill and decode of the dense,
hybrid (a window) and audio (a non-causal encoder) families at
``reduced()`` with blocks of 8 queries and 16 keys, so that the tiles
run, against the JAX models (fp32 1e-5, bf16 2e-2), and the train step on
``blocked`` against the reference's ``build_train_step``, whose default
it is (losses 1e-5 relative, gradients 1e-4 of each leaf's largest
magnitude).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.kernels.flash_attention import ops as jfa_ops
from repro.models import attention as jattn
from repro.models.registry import get_model as jax_get_model
from repro.training import build_train_step as jax_build_train_step
from repro.training import init_state as jax_init_state
from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig
from repro_torch.kernels.flash_attention import ops as tfa_ops
from repro_torch.models import attention as tattn
from repro_torch.models.convert import params_from_jax, state_from_jax
from repro_torch.models.registry import get_model
from repro_torch.training import build_train_step, loss_and_grads
from repro_torch.utils import tree_leaves

TOL = {"float32": 2e-6, "bfloat16": 2e-2}
GRAD_TOL = 1e-5
MODEL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BLOCKS = dict(attention_block_q=8, attention_block_kv=16)

# name -> (B, Sq, Skv, H, KH, hd, causal, window)
CASES = {
    "causal": (2, 40, 40, 4, 2, 16, True, 0),
    "causal_ragged": (2, 37, 37, 4, 2, 16, True, 0),
    "window": (2, 37, 37, 4, 1, 16, True, 5),
    "non_causal": (2, 37, 37, 4, 4, 16, False, 0),
    "cross": (2, 21, 37, 4, 2, 16, False, 0),
}
SCHEDULES = ("blocked", "skip", "triangular")


def _inputs(name, seed=0):
    B, Sq, Skv, H, KH, hd, causal, window = CASES[name]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k, v = (np.repeat(rng.standard_normal((B, Skv, KH, hd)).astype(
        np.float32), H // KH, axis=2) for _ in range(2))
    qpos = np.broadcast_to(np.arange(Sq), (B, Sq)).astype(np.int32)
    kpos = np.broadcast_to(np.arange(Skv), (B, Skv)).astype(np.int32)
    return (q, k, v, qpos, kpos), causal, window


def _jax(schedule, q, k, v, qpos, kpos, causal, window):
    if schedule == "triangular":
        return jattn.triangular_attention(q, k, v, qpos, kpos, causal,
                                          window, block=8)
    return jattn.blocked_attention(q, k, v, qpos, kpos, causal, window,
                                   block_q=8, block_kv=16,
                                   skip_blocks=schedule == "skip")


def _port(schedule, q, k, v, qpos, kpos, causal, window):
    if schedule == "triangular":
        return tattn.triangular_attention(q, k, v, qpos, kpos, causal,
                                          window, block=8)
    return tattn.blocked_attention(q, k, v, qpos, kpos, causal, window,
                                   block_q=8, block_kv=16,
                                   skip_blocks=schedule == "skip")


def _applies(schedule, name):
    """The triangular schedule is for causal self-attention only."""
    _, Sq, Skv, _, _, _, causal, _ = CASES[name]
    return schedule != "triangular" or (causal and Sq == Skv)


def _pairs(names):
    return [(n, s) for n in names for s in SCHEDULES if _applies(s, n)]


def _t(x, dtype=torch.float32):
    x = torch.from_numpy(np.ascontiguousarray(x))
    return x.long() if x.dtype == torch.int32 else x.to(dtype)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * max(scale, 1.0 if tol > 1e-3
                                              else scale))


# -- the schedules -----------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,schedule", _pairs(CASES))
def test_torch_schedule_matches_jax_and_naive(name, schedule, dtype):
    (q, k, v, qpos, kpos), causal, window = _inputs(name)
    tdt = getattr(torch, dtype)
    targs = [_t(x, tdt) for x in (q, k, v)] + [_t(qpos), _t(kpos)]
    got = _port(schedule, *targs, causal, window)
    assert got.dtype == tdt and got.shape == targs[0].shape
    jargs = [jnp.asarray(x, dtype) for x in (q, k, v)] + [
        jnp.asarray(qpos), jnp.asarray(kpos)]
    want = _jax(schedule, *jargs, causal, window)
    naive = tattn.naive_attention(*targs, causal, window)
    _close(got.float().numpy(), np.asarray(want, np.float32), TOL[dtype])
    _close(got.float().numpy(), naive.float().numpy(), TOL[dtype])


def test_torch_tiles_issued_at_train_4k():
    """At 4,096 tokens, blocks 512 x 1,024: every one of 32 tiles, 20 with
    ``_skip_blocks``, and 36 of the 64 (512 x 512) tiles of the triangular
    schedule, the reference's own counts."""
    issued = [sum(map(len, tiles)) for tiles in (
        tattn.blocked_tiles(8, 4, 512, 1024, True, 0, False),
        tattn.blocked_tiles(8, 4, 512, 1024, True, 0, True),
        tattn.triangular_tiles(8, 512, 0))]
    assert issued == [32, 20, 36]
    # with a window of 600, only the diagonal and the two blocks before it
    assert sum(map(len, tattn.triangular_tiles(8, 512, 600))) == 21
    assert sum(map(len, tattn.blocked_tiles(8, 4, 512, 1024, False, 0,
                                            True))) == 32


@pytest.mark.parametrize("name,schedule",
                         _pairs(["causal_ragged", "window", "cross"]))
def test_torch_schedule_gradients_match_naive_and_jax(name, schedule):
    """d(sum(out * w)) / d(q, k, v) through the tiles."""
    (q, k, v, qpos, kpos), causal, window = _inputs(name, seed=1)
    w = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)

    def port_grads(fn):
        leaves = [_t(x).requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, _t(qpos), _t(kpos), causal, window)
        return torch.autograd.grad((out * _t(w)).sum(), leaves)

    got = port_grads(lambda *a: _port(schedule, *a))
    naive = port_grads(tattn.naive_attention)
    want = jax.grad(lambda q, k, v: jnp.sum(_jax(
        schedule, q, k, v, jnp.asarray(qpos), jnp.asarray(kpos), causal,
        window) * w), argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    for g, n, j in zip(got, naive, want):
        _close(g.numpy(), np.asarray(j), GRAD_TOL)
        _close(g.numpy(), n.numpy(), GRAD_TOL)


def test_torch_triangular_refuses_cross_attention():
    (q, k, v, qpos, kpos), _, _ = _inputs("cross")
    with pytest.raises(ValueError, match="self-attention"):
        tattn.triangular_attention(_t(q), _t(k), _t(v), _t(qpos), _t(kpos))


# -- the dispatch ------------------------------------------------------------------
DISPATCH = [(impl, causal, window, sq, skv, skip)
            for impl in ("flash", "naive", "blocked", "triangular")
            for causal, window in ((True, 0), (True, 4), (False, 0))
            for sq, skv in ((1, 40), (8, 8), (9, 9), (40, 40), (40, 24))
            for skip in ((False, True) if impl == "blocked" else (False,))]
JAX_IMPL = {"flash": "pallas"}


def _spy(monkeypatch, module, names, seen):
    """Each of ``names`` records its call (name, skip_blocks, block) and
    returns q unchanged: the branch, not the function, is under test."""
    for name in names:
        def spy(*args, _name=name, **kw):
            seen.append((_name, kw.get("skip_blocks"),
                         kw.get("block_q", kw.get("block"))))
            return args[0]
        monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("impl,causal,window,sq,skv,skip", DISPATCH)
def test_torch_dispatch_takes_the_references_branch(
        monkeypatch, impl, causal, window, sq, skv, skip):
    """The branch each package takes for one call; where the reference
    takes its Pallas kernel, the port on the CPU takes the branch the
    reference takes next (its default ``blocked``), the plain version of
    the kernel's function."""
    over = {"_skip_blocks": True} if skip else {}
    jcfg = jax_get_config("internlm2-1.8b", reduced=True).replace(
        attention_impl=JAX_IMPL.get(impl, impl), sharding_overrides=over,
        **BLOCKS)
    tcfg = get_config("internlm2-1.8b", reduced=True).replace(
        attention_impl=impl, sharding_overrides=over, **BLOCKS)
    names = ("naive_attention", "blocked_attention", "triangular_attention")
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, sq, 2, 8)).astype(np.float32)
    k, v = (rng.standard_normal((1, skv, 2, 8)).astype(np.float32)
            for _ in range(2))
    qpos = np.arange(skv - sq, skv, dtype=np.int32)[None]
    kpos = np.arange(skv, dtype=np.int32)[None]

    def branch(module, fa_module, core, cfg, conv):
        seen = []
        _spy(monkeypatch, module, names, seen)
        _spy(monkeypatch, fa_module, ("flash_attention",), seen)
        core(*(conv(x) for x in (q, k, v, qpos, kpos)), cfg, causal=causal,
             window=window)
        return seen

    want = branch(jattn, jfa_ops, jattn.attention_core, jcfg, jnp.asarray)
    got = branch(tattn, tfa_ops, tattn.attention_core, tcfg, _t)
    assert len(want) == len(got) == 1
    if want[0][0] == "flash_attention":
        monkeypatch.undo()
        want = branch(jattn, jfa_ops, jattn.attention_core,
                      jcfg.replace(attention_impl="blocked"), jnp.asarray)
    assert got == want


def test_torch_every_attention_impl_is_served():
    with pytest.raises(ValueError, match="attention_impl='pallas'"):
        tcfg = get_config("internlm2-1.8b", reduced=True).replace(
            attention_impl="pallas")
        x = torch.zeros((1, 2, 4, 16))
        pos = torch.arange(2)[None]
        tattn.attention_core(x, x, x, pos, pos, tcfg)
    assert tattn.ATTENTION_IMPLS == ("flash", "naive", "blocked",
                                     "triangular")


# -- prefill and decode, and the train step, with the tiles running ---------------------
PROMPT = 20             # past the 8-query block, and recurrentgemma's window


def _model_configs(arch, dtype, **kw):
    kw = dict(dtype=dtype, param_dtype=dtype, **BLOCKS, **kw)
    return (jax_get_config(arch, reduced=True).replace(**kw),
            get_config(arch, reduced=True).replace(**kw))


@pytest.mark.parametrize("arch,impl,dtype", [
    ("internlm2-1.8b", "flash", "float32"),
    ("internlm2-1.8b", "flash", "bfloat16"),
    ("internlm2-1.8b", "triangular", "float32"),
    ("internlm2-1.8b", "skip", "float32"),
    ("recurrentgemma-2b", "flash", "float32"),
    ("whisper-medium", "flash", "float32"),
])
def test_torch_prefill_and_decode_match_jax_on_the_tiles(
        monkeypatch, arch, impl, dtype):
    """A 20-token prefill (and whisper's 12 frames) past the 8-query
    block, then three decode steps, against the JAX model on its
    ``blocked`` default (or the same schedule): every step's logits."""
    over = {"_skip_blocks": True} if impl == "skip" else {}
    jimpl = {"flash": "blocked", "skip": "blocked"}.get(impl, impl)
    timpl = "blocked" if impl == "skip" else impl
    jcfg, tcfg = _model_configs(arch, dtype, sharding_overrides=over)
    jcfg, tcfg = (jcfg.replace(attention_impl=jimpl),
                  tcfg.replace(attention_impl=timpl))
    jmodel, tmodel = jax_get_model(jcfg), get_model(tcfg)
    jp = jmodel.init(jax.random.PRNGKey(4), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    rng = np.random.default_rng(5)
    B, S, steps = 2, PROMPT, 3
    tok = rng.integers(0, tcfg.vocab_size, (B, S), dtype=np.int32)
    jb, tb = {"tokens": jnp.asarray(tok)}, {"tokens": _t(tok)}
    if tcfg.family == "audio":
        frames = rng.standard_normal((B, tcfg.encoder_seq, tcfg.d_model)
                                     ).astype(np.float32)
        jb["frames"], tb["frames"] = jnp.asarray(frames), _t(frames)
    calls = []
    blocked = tattn.blocked_attention

    def counted(*args, **kw):
        calls.append(kw.get("skip_blocks"))
        return blocked(*args, **kw)

    monkeypatch.setattr(tattn, "blocked_attention", counted)
    jl, jc = jmodel.prefill(jp, jb, jcfg, max_len=S + steps)
    tl, tc = tmodel.prefill(tp, tb, tcfg, max_len=S + steps)
    # the tiles ran: every layer's attention but the triangular schedule's
    assert (not calls) == (impl == "triangular")
    assert set(calls) <= {impl == "skip"}
    _close(tl.float().numpy(), np.asarray(jl, np.float32), MODEL_TOL[dtype])
    for i in range(steps):
        nxt = rng.integers(0, tcfg.vocab_size, (B, 1), dtype=np.int32)
        jl, jc = jmodel.decode_step(jp, jnp.asarray(nxt), jc, jcfg)
        tl, tc = tmodel.decode_step(tp, _t(nxt), tc, tcfg)
        _close(tl.float().numpy(), np.asarray(jl, np.float32),
               MODEL_TOL[dtype])


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "recurrentgemma-2b"])
def test_torch_train_step_on_blocked_matches_jax(arch):
    """The port's default (``flash``, trained as ``blocked``) against the
    reference's default ``blocked``, with the tiles running: the step-1
    gradients within 1e-4 of each leaf's largest magnitude, and three
    steps' losses within 1e-5 relative."""
    jcfg, tcfg = _model_configs(arch, "float32")
    assert jcfg.attention_impl == "blocked" and tcfg.attention_impl == "flash"
    jopt = JOptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=40,
                            zero1=False)
    topt = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=40,
                           zero1=False)
    jstate = jax_init_state(jax.random.PRNGKey(6), jcfg, jopt)
    tstate = state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), tcfg)
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, tcfg.vocab_size, (2, 20), dtype=np.int32)
               for _ in range(3)]
    jmodel = jax_get_model(jcfg)
    _, jg = jax.value_and_grad(lambda p: jmodel.loss_and_metrics(
        p, {"tokens": jnp.asarray(batches[0])}, jcfg), has_aux=True)(
            jstate["params"])
    _, _, tg = loss_and_grads(tstate["params"], {"tokens": _t(batches[0])},
                              tcfg.replace(attention_impl="blocked"))
    for g, w in zip(tree_leaves(tg), tree_leaves(params_from_jax(
            jax.tree_util.tree_map(np.asarray, jg), tcfg))):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-4 * max(scale, 1e-30)
    jstep = jax.jit(jax_build_train_step(jcfg, jopt))
    tstep = build_train_step(tcfg, topt)
    jl, tl = [], []
    for tok in batches:
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tok)})
        tstate, tm = tstep(tstate, {"tokens": _t(tok)})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
