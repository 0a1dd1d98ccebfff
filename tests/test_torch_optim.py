"""The port's AdamW against the reference and a numpy reference, on the
CPU: ``lr_schedule``, ``clip_by_global_norm``, ``init_opt_state``,
``adamw_update`` (which leaves decay, in a stacked family and in rglru),
the optimizer state carried across by ``convert.state_from_jax``, and
the train step's 5-step loss curve against the reference's for each
family.

Tolerances: the schedule and the clipping scale are fp32 tensor math in
both packages, held to 1e-6 relative; AdamW against the numpy reference
keeps tests/test_optim.py's 2e-5 / 2e-6; one update against the
reference's ``adamw_update`` 1e-6 relative with 1e-7 absolute (the same
fp32 expression, evaluated by two libraries); the loss curves 1e-4
relative (tests/test_torch_training.py says why).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.optim import adamw as jadamw
from repro.training import build_train_step as jax_build_train_step
from repro.training import init_state as jax_init_state
from repro_torch.configs.base import OptimizerConfig
from repro_torch.models.convert import params_from_jax, state_from_jax
from repro_torch.optim import (adamw_update, clip_by_global_norm,
                               init_opt_state, lr_schedule, reference_ndim)
from repro_torch.training import build_train_step
from repro_torch.utils import tree_leaves
from tests.test_torch_training import (_batch, _configs, _jbatch, _np,
                                       _tbatch)

CURVE_TOL = 1e-4


def _numpy_adamw(p, g, m, v, step, cfg):
    """tests/test_optim.py:numpy_adamw."""
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    mh = m / (1 - cfg.b1 ** step)
    vh = v / (1 - cfg.b2 ** step)
    delta = mh / (np.sqrt(vh) + cfg.eps)
    lr = float(lr_schedule(torch.tensor(step), cfg))
    if p.ndim >= 2:
        delta = delta + cfg.weight_decay * p
    return p - lr * delta, m, v


# -- the schedule and the clipping ---------------------------------------------------
def test_torch_lr_schedule_matches_jax():
    """Warmup 10, cosine to 10 % at 100, past the end and at a degenerate
    warmup, step by step in fp32 against the reference's."""
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100),
               dict(lr=3e-4, warmup_steps=0, total_steps=7),
               dict(lr=1e-3, warmup_steps=2, total_steps=40)):
        tcfg, jcfg = OptimizerConfig(**kw), JOptimizerConfig(**kw)
        for s in range(0, 130):
            got = lr_schedule(torch.tensor(s, dtype=torch.int32), tcfg)
            want = jadamw.lr_schedule(jnp.asarray(s, jnp.int32), jcfg)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       err_msg=str((kw, s)))


def test_torch_lr_schedule_shape():
    """The counterpart of tests/test_optim.py::test_lr_schedule_shape."""
    cfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100)
    lrs = [float(lr_schedule(torch.tensor(s), cfg)) for s in range(101)]
    assert lrs[0] == 0.0
    np.testing.assert_allclose(lrs[10], 1.0, rtol=1e-6)
    assert all(a >= b - 1e-9 for a, b in zip(lrs[10:], lrs[11:]))
    np.testing.assert_allclose(lrs[100], 0.1, rtol=1e-5)


def test_torch_grad_clip_global_norm():
    """The counterpart of tests/test_optim.py::test_grad_clip_global_norm."""
    g = {"a": torch.full((10,), 3.0), "b": torch.full((10,), 4.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    total = np.sqrt(sum(float(torch.sum(torch.square(x)))
                        for x in tree_leaves(clipped)))
    np.testing.assert_allclose(float(norm), np.sqrt(250.0), rtol=1e-6)
    np.testing.assert_allclose(total, 1.0, rtol=1e-5)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_torch_grad_clip_matches_jax(max_norm):
    """A tree of mixed dtypes and ranks, clipped (0.5) and not (1e3):
    the norm and every leaf, each in its dtype, against the reference's."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((5, 7)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32),
            "layers": [rng.standard_normal((3, 4)).astype(np.float32)
                       for _ in range(2)]}
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    jt["h"] = jnp.asarray(tree["w"], jnp.bfloat16)
    tt = jax.tree_util.tree_map(torch.from_numpy, tree)
    tt["h"] = torch.from_numpy(tree["w"]).to(torch.bfloat16)
    jc, jn = jadamw.clip_by_global_norm(jt, max_norm)
    tc, tn = clip_by_global_norm(tt, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for key in ("w", "b", "h"):
        assert tc[key].dtype == tt[key].dtype
        np.testing.assert_allclose(tc[key].float().numpy(),
                                   np.asarray(jc[key], np.float32),
                                   rtol=1e-6, atol=1e-7)


# -- the update ----------------------------------------------------------------------
def test_torch_adamw_matches_numpy_reference():
    """The counterpart of tests/test_optim.py::test_adamw_matches_numpy_
    reference: five steps on a (4, 6) leaf, fp32 master weights."""
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=10 ** 9,
                          grad_clip=0.0, master_fp32=True, zero1=False)
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((4, 6)).astype(np.float32)
    params = {"w": torch.from_numpy(p0.copy())}
    state = init_opt_state(params, cfg)
    p_ref, m_ref, v_ref = p0.copy(), np.zeros_like(p0), np.zeros_like(p0)
    for step in range(1, 6):
        g = rng.standard_normal((4, 6)).astype(np.float32)
        params, state, _ = adamw_update(params, {"w": torch.from_numpy(g)},
                                        state, cfg)
        p_ref, m_ref, v_ref = _numpy_adamw(p_ref, g, m_ref, v_ref, step, cfg)
        np.testing.assert_allclose(params["w"].numpy(), p_ref, rtol=2e-5,
                                   atol=2e-6)
    assert int(state["step"]) == 5


@pytest.mark.parametrize("master_fp32", [True, False])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_torch_adamw_update_matches_jax(master_fp32, param_dtype):
    """Five steps with warmup and clipping on a tree of ranks 0-3, against
    the reference's ``adamw_update`` from the same state: the parameters,
    the master copy, the moments and the metrics."""
    rng = np.random.default_rng(1)
    shapes = {"w": (6, 5), "b": (5,), "s": (), "e": (2, 3, 4)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=1.0,
              master_fp32=master_fp32, zero1=False)
    tcfg, jcfg = OptimizerConfig(**kw), JOptimizerConfig(**kw)
    tdt = getattr(torch, param_dtype)
    tp = {k: torch.from_numpy(v.copy()).to(tdt) for k, v in p0.items()}
    jp = {k: jnp.asarray(v).astype(param_dtype) for k, v in p0.items()}
    ts, js = init_opt_state(tp, tcfg), jadamw.init_opt_state(jp, jcfg)
    for _ in range(5):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        tp, ts, tm = adamw_update(
            tp, {k: torch.from_numpy(v).to(tdt) for k, v in g.items()},
            ts, tcfg)
        jp, js, jm = jadamw.adamw_update(
            jp, {k: jnp.asarray(v).astype(param_dtype)
                 for k, v in g.items()}, js, jcfg)
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)
        trees = [("params", tp, jp), ("m", ts["m"], js["m"]),
                 ("v", ts["v"], js["v"])]
        if master_fp32:
            trees.append(("master", ts["master"], js["master"]))
        for name, got, want in trees:
            for k in shapes:
                assert got[k].dtype == (tdt if name == "params"
                                        else torch.float32)
                np.testing.assert_allclose(
                    got[k].float().numpy(), np.asarray(want[k], np.float32),
                    rtol=1e-6, atol=1e-7, err_msg=f"{name}.{k}")
    assert int(ts["step"]) == int(js["step"]) == 5


def test_torch_init_opt_state_copies_the_master():
    """fp32 parameters get a master copy of their own: the in-place update
    must not write the master and the parameters through one tensor."""
    cfg = OptimizerConfig(zero1=False)
    params = {"w": torch.ones((2, 3))}
    state = init_opt_state(params, cfg)
    assert state["master"]["w"].data_ptr() != params["w"].data_ptr()
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    bf = init_opt_state({"w": torch.ones(3, dtype=torch.bfloat16)},
                        OptimizerConfig(state_dtype="bfloat16",
                                        master_fp32=False, zero1=False))
    assert bf["m"]["w"].dtype == torch.bfloat16 and "master" not in bf



@pytest.mark.parametrize("change", [dict(zero1=True),
                                    dict(zero1=False, compression="int8")])
def test_torch_adamw_reads_the_mesh_options_as_the_reference(change):
    """Without a mesh ``zero1`` and ``compression`` change nothing, as in
    the reference's ``init_opt_state`` and ``adamw_update``: the config is
    accepted, and its step equals the ``zero1=False, compression=None``
    step and the reference's ``adamw_update`` on the same inputs (ZeRO-1
    over a mesh is tests/test_torch_mesh.py's). The reference's defaults
    ask for ZeRO-1."""
    assert OptimizerConfig().zero1 is JOptimizerConfig().zero1 is True
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal((3, 4)).astype(np.float32)
    g = rng.standard_normal((3, 4)).astype(np.float32)
    kw = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    outs = []
    for cfg in (OptimizerConfig(**kw, **change),
                OptimizerConfig(**kw, zero1=False, compression=None)):
        params = {"w": torch.from_numpy(p0.copy())}
        state = init_opt_state(params, cfg)
        params, state, _ = adamw_update(params, {"w": torch.from_numpy(g)},
                                        state, cfg)
        outs.append((params["w"].clone(), state["m"]["w"].clone(),
                     int(state["step"])))
    (got, m_got, step_got), (want, m_want, step_want) = outs
    assert torch.equal(got, want) and torch.equal(m_got, m_want)
    assert step_got == step_want == 1
    jcfg = JOptimizerConfig(**kw, **change)
    jparams = {"w": jnp.asarray(p0)}
    jp, _, _ = jadamw.adamw_update(jparams, {"w": jnp.asarray(g)},
                                   jadamw.init_opt_state(jparams, jcfg),
                                   jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(jp["w"]), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("name", ["OptimizerConfig", "RunConfig",
                                  "ShapeConfig"])
def test_torch_config_dataclasses_match_the_reference(name):
    """The port's copies of the reference's run dataclasses have its
    fields, in its order, with its defaults."""
    from dataclasses import MISSING, fields

    import repro.configs.base as jbase
    import repro_torch.configs.base as tbase

    def spec(cls):
        out = []
        for f in fields(cls):
            d = f.default_factory() if f.default_factory is not MISSING \
                else f.default
            out.append((f.name, d if f.name != "optimizer" else
                        [(g.name, getattr(d, g.name)) for g in fields(d)]))
        return out
    assert spec(getattr(tbase, name)) == spec(getattr(jbase, name))


def test_torch_shapes_match_the_reference():
    """``SHAPES``, ``SMOKE_SHAPE`` and ``applicable_shapes`` for every
    ported arch are the reference's."""
    import repro.configs.base as jbase
    import repro_torch.configs.base as tbase
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import REFERENCE_ARCHS, get_config

    def as_tuple(shape):
        return (shape.name, shape.seq_len, shape.global_batch, shape.kind)
    assert ({k: as_tuple(v) for k, v in tbase.SHAPES.items()}
            == {k: as_tuple(v) for k, v in jbase.SHAPES.items()})
    assert as_tuple(tbase.SMOKE_SHAPE) == as_tuple(jbase.SMOKE_SHAPE)
    for arch in sorted(REFERENCE_ARCHS):
        assert (tbase.applicable_shapes(get_config(arch))
                == jbase.applicable_shapes(jax_get_config(arch))), arch

def _decayed(arch):
    """One step with zero gradients in both packages from one state: the
    leaves whose parameters moved (weight decay alone moves them), keyed
    in the port's tree, and the largest difference between the packages'
    parameters after the step."""
    jcfg, tcfg = _configs(arch)
    kw = dict(lr=1e-2, warmup_steps=0, total_steps=100, grad_clip=0.0,
              zero1=False)
    jopt, topt = JOptimizerConfig(**kw), OptimizerConfig(**kw)
    jstate = jax_init_state(jax.random.PRNGKey(0), jcfg, jopt)
    tstate = state_from_jax(_np(jstate), tcfg)
    before = [p.clone() for p in tree_leaves(tstate["params"])]
    jzero = jax.tree_util.tree_map(jnp.zeros_like, jstate["params"])
    jp, _, _ = jadamw.adamw_update(jstate["params"], jzero, jstate["opt"],
                                   jopt)
    tzero = jax.tree_util.tree_map(torch.zeros_like, tstate["params"])
    tp, _, _ = adamw_update(tstate["params"], tzero, tstate["opt"], topt)
    want = tree_leaves(params_from_jax(_np(jp), tcfg))
    got = tree_leaves(tp)
    moved = [not torch.equal(a, b) for a, b in zip(got, before)]
    worst = max(float((a - b).abs().max()) for a, b in zip(got, want))
    return moved, tree_leaves(reference_ndim(tp)), got, worst


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "rwkv6-7b",
                                  "whisper-medium", "recurrentgemma-2b"])
def test_torch_weight_decay_follows_the_reference_leaf_rank(arch):
    """The reference decays a leaf iff its rank in the reference's tree is
    2 or more: in the stacked families (transformer, rwkv6, whisper) every
    per-layer norm scale and bias and rwkv6's per-layer vectors are (L, D)
    there and decay; rglru's per-layer dicts keep their 1-D leaves, which
    do not. A step with zero gradients moves exactly the decayed leaves,
    to the reference's values."""
    moved, ref_ndim, leaves, worst = _decayed(arch)
    for m, n, p in zip(moved, ref_ndim, leaves):
        if float(p.abs().max()) > 0:
            assert m == (n >= 2), (n, tuple(p.shape))
    assert worst < 1e-7
    one_d = [m for m, p in zip(moved, leaves) if p.dim() == 1]
    if arch == "recurrentgemma-2b":
        assert one_d and not any(one_d)
    else:
        assert any(one_d)


# -- the train step against the reference's, five steps ----------------------------------
CURVE_ARCHS = ["internlm2-1.8b", "granite-moe-3b-a800m", "rwkv6-7b",
               "recurrentgemma-2b", "whisper-medium"]


def _opt_pair(**kw):
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=40, zero1=False, **kw)
    return JOptimizerConfig(**kw), OptimizerConfig(**kw)


def loss_curves(arch, steps=5):
    """Both packages' train steps from one state (the reference's init,
    converted) over the same ``steps`` batches: their per-step losses."""
    jcfg, tcfg = _configs(arch)
    jopt, topt = _opt_pair()
    jstate = jax_init_state(jax.random.PRNGKey(0), jcfg, jopt)
    tstate = state_from_jax(_np(jstate), tcfg)
    jstep = jax.jit(jax_build_train_step(jcfg, jopt))
    tstep = build_train_step(tcfg, topt)
    jl, tl = [], []
    for i in range(steps):
        batch = _batch(tcfg, 100 + i)
        jstate, jm = jstep(jstate, _jbatch(batch))
        tstate, tm = tstep(tstate, _tbatch(batch))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        for key in ("lr", "grad_norm", "total_loss"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=CURVE_TOL, err_msg=key)
    return np.array(tl), np.array(jl)


@pytest.mark.parametrize("arch", CURVE_ARCHS)
def test_torch_loss_curve_matches_jax(arch):
    """Five fp32 steps of ``build_train_step`` against the reference's:
    the losses (and lr, grad_norm, total_loss) within 1e-4 relative."""
    got, want = loss_curves(arch)
    np.testing.assert_allclose(got, want, rtol=CURVE_TOL)


