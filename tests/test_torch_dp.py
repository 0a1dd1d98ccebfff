"""The port's explicit-collective data-parallel trainer
(``repro_torch.parallel.dp``) on spawned gloo ranks, against the port's
one-process trainer and the JAX package's ``build_dp_train_step``.

* The counterparts of tests/test_dp.py on 8 gloo ranks: the DP step
  against the one-process ``build_train_step`` (3 steps, losses within
  1e-2, parameters within rtol 2e-2 and atol 2e-3, the reference's
  bounds), and int8-compressed training converging (a fall of 0.3 or more
  in 12 steps).
* The same converted parameters and batch through the reference's DP
  step on 8 virtual devices (tests/test_multidevice.py's subprocess) and
  the port's on 8 ranks, 3 steps with weight decay 0.1 (which the flat
  vector applies to every element): each rank's master shard (and with
  int8 its m), and the gathered parameters; bf16 parameters and fp32
  parameters (which the all-gather rounds to bf16 in both packages), and
  int8.
* ``flatten_params``/``unflatten_params`` round trips, the padding
  included; a group of one process; the refusal without a group.

Tolerances: the losses within 1e-5 relative of the reference's (fp32
activations, so the two frameworks' gradients agree to fp32 round-off);
each rank's master within 1e-5 of its largest magnitude on all but a
share of its elements (0.1 %, 2 % with int8; seen: 1 of 13,352 a rank, up
to 78 with int8), each of which stays within two AdamW trajectories' reach
(3 steps of at most lr · 1.001, the largest |m_hat / sqrt(v_hat)| of
steps 1-3): AdamW's first steps move an element by about lr · sign(g), so
an element whose gradient cancels to round-off, or with int8 whose code
rounds the other way, steps differently. The parameters on the other
elements within one bf16 ulp plus the masters' 1e-5 (each side rounds its
master to bf16). With int8, the first moment m within one quantum: each
reduced gradient element is a sum of 8 codes on the shared scale, one
code moved by round-off moves it by scale / 8, and m weighs three steps'
gradients by 1 - 0.9³ < 1 in all, so m stays within the largest step's
scale (max |g| / 127, recorded by the ranks).
"""
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import init_opt_state
from repro_torch.parallel import (build_dp_train_step, flatten_params,
                                  init_dp_opt_state, shard_batch,
                                  unflatten_params)
from repro_torch.training import (build_train_step, loss_and_grads,
                                  train_config)
from repro_torch.utils import tree_leaves, tree_map
from tests.test_multidevice import run_with_devices
from tests.test_torch_bridge import spawn_ranks

ARCH = "internlm2-1.8b"
WORLD, B, S = 8, 8, 32
STEPS, CONVERGE_STEPS, CONVERGE_DROP = 3, 12, 0.3
LOSS_ATOL, PARAM_TOL = 1e-2, dict(rtol=2e-2, atol=2e-3)   # test_dp.py:34-44
MASTER_TOL = 1e-5
# the share of elements allowed past MASTER_TOL, by compression (seen: 1 of
# 13,352 a rank without compression, up to 78 with int8)
OFF_SHARE = {None: 1e-3, "int8": 2e-2}
# the largest |m_hat / sqrt(v_hat)| of AdamW at steps 1-3, b1 0.9, b2 0.95
# (Cauchy-Schwarz over the bias-corrected weights)
ADAM_RATIO = 1.001
# tests/test_dp.py's optimizer; the JAX cases decay by 0.1
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=50, zero1=False,
           grad_clip=1.0, weight_decay=0.0)
CONVERGE_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=40, zero1=False)
# name -> (param dtype, compression); the activations in fp32, so that the
# two frameworks' gradients agree to fp32 round-off
JAX_CASES = {"bf16": ("bfloat16", None), "fp32": ("float32", None),
             "int8": ("bfloat16", "int8")}
JAX_DECAY = 0.1
N_LEAVES = 12           # the reduced transformer's leaves, stacked on L


def _configs(param_dtype="bfloat16", dtype=None):
    """reduced(); ``dtype`` (the activations') defaults to the parameters'."""
    kw = dict(dtype=dtype or param_dtype, param_dtype=param_dtype)
    return (jax_get_config(ARCH, reduced=True).replace(**kw),
            get_config(ARCH, reduced=True).replace(**kw))


def _tokens(vocab):
    return np.random.default_rng(7).integers(0, vocab, (B, S),
                                             dtype=np.int32)


def _jax_params(param_dtype="bfloat16"):
    """The reference's init from PRNGKey(0), and the port's copy of it."""
    jcfg, tcfg = _configs(param_dtype)
    jp = jtransformer.init(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


# -- the ranks ---------------------------------------------------------------------
def _run(group, config, opt, params, tokens, steps, compression=None):
    state = {"params": _clone(params)}
    state["opt"] = init_dp_opt_state(state["params"], group, opt)
    step = build_dp_train_step(config, opt, group, compression)
    batch = shard_batch({"tokens": torch.from_numpy(tokens).long()}, group)
    losses, quantum = [], 0.0
    for _ in range(steps):
        if compression == "int8":
            # the step's shared scale, max |g| over the ranks / 127
            _, _, grads = loss_and_grads(state["params"], batch,
                                         train_config(config))
            amax = torch.stack([g.abs().max().float()
                                for g in tree_leaves(grads)]).max()
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
            quantum = max(quantum, float(amax) / 127)
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    # numpy across the process boundary: fp32, which holds bf16 exactly
    return {"losses": losses, "step": int(state["opt"]["step"]),
            "quantum": quantum,
            "params": flatten_params(state["params"], 1)[0].numpy(),
            "dtypes": {str(p.dtype) for p in tree_leaves(state["params"])},
            **{k: state["opt"][k].float().numpy()
               for k in ("master", "m", "v")}}


def _dp_rank(rank, world, params, fp32_params, tokens):
    group = dist.group.WORLD
    _, tcfg = _configs()
    out = {"plain": _run(group, tcfg, OptimizerConfig(**OPT), params,
                         tokens, STEPS),
           "converge": _run(group, tcfg, OptimizerConfig(**CONVERGE_OPT),
                            params, tokens, CONVERGE_STEPS, "int8")}
    decay = OptimizerConfig(**{**OPT, "weight_decay": JAX_DECAY})
    for name, (dtype, comp) in JAX_CASES.items():
        out["jax_" + name] = _run(
            group, _configs(dtype, "float32")[1], decay,
            fp32_params if dtype == "float32" else params, tokens, STEPS,
            comp)
    return out


@pytest.fixture(scope="module")
def inputs():
    jcfg, tcfg = _configs()
    _, params = _jax_params()
    _, fp32_params = _jax_params("float32")
    return {"params": params, "fp32_params": fp32_params,
            "tokens": _tokens(tcfg.vocab_size), "config": tcfg}


@pytest.fixture(scope="module")
def gloo8(inputs, tmp_path_factory):
    return spawn_ranks(_dp_rank, WORLD, (inputs["params"],
                                         inputs["fp32_params"],
                                         inputs["tokens"]),
                       tmp_path_factory.mktemp("dp8"))


def _one_rank(rank, world, params, tokens):
    _, tcfg = _configs()
    return _run(dist.group.WORLD, tcfg, OptimizerConfig(**OPT), params,
                tokens, STEPS)


# -- the reference, on 8 virtual devices -------------------------------------------
_REFERENCE = """
    import jax, numpy as np
    from repro.configs import get_config
    from repro.configs.base import OptimizerConfig
    from repro.models import transformer
    from repro.parallel.dp import build_dp_train_step, init_dp_opt_state
    from repro.utils import make_mesh_compat

    mesh = make_mesh_compat((8,), ("data",))
    opt = OptimizerConfig(**{opt!r})
    tokens = np.random.default_rng(7).integers(0, 256, ({b}, {s}),
                                               dtype=np.int32)
    out = {{}}
    for name, (dtype, comp) in {cases!r}.items():
        cfg = get_config("internlm2-1.8b", reduced=True).replace(
            dtype="float32", param_dtype=dtype)
        params = transformer.init(jax.random.PRNGKey(0), cfg)
        state = {{"params": params,
                  "opt": init_dp_opt_state(params, mesh, opt)}}
        step, _ = build_dp_train_step(cfg, opt, mesh, compression=comp)
        losses = []
        for _ in range({steps}):
            state, m = step(state, {{"tokens": tokens}})
            losses.append(float(m["loss"]))
        out[name + "/losses"] = np.asarray(losses)
        for k in ("master", "m"):
            out[name + "/" + k] = np.asarray(state["opt"][k], np.float32)
        for i, leaf in enumerate(jax.tree_util.tree_leaves(state["params"])):
            out[name + "/param/" + str(i)] = np.asarray(leaf, np.float32)
    np.savez({path!r}, **out)
    print("OK")
"""


@pytest.fixture(scope="module")
def ref(inputs, tmp_path_factory):
    assert inputs["config"].vocab_size == 256
    path = str(tmp_path_factory.mktemp("dp_ref") / "ref.npz")
    run_with_devices(textwrap.dedent(_REFERENCE).format(
        opt={**OPT, "weight_decay": JAX_DECAY}, b=B, s=S, cases=JAX_CASES,
        steps=STEPS, path=path))
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _to_port(jleaves, dtype, tcfg):
    """Flat reference leaves (in ``jax.tree_util`` order) as the port's
    tree, through the reference init's structure."""
    jp, _ = _jax_params(dtype)
    treedef = jax.tree_util.tree_structure(jp)
    return params_from_jax(jax.tree_util.tree_unflatten(treedef, jleaves),
                           tcfg)


def _ref_flat(ref, name, key, dtype, tcfg):
    """The reference's flat ``key`` vector (master, m or v) in the port's
    leaf order, padded to WORLD."""
    jp, _ = _jax_params(dtype)
    leaves = jax.tree_util.tree_leaves(jp)
    vec, off, pieces = ref[f"{name}/{key}"], 0, []
    for leaf in leaves:
        pieces.append(vec[off:off + leaf.size].reshape(leaf.shape))
        off += leaf.size
    flat, _ = flatten_params(_to_port(pieces, dtype, tcfg), WORLD)
    return flat.numpy().reshape(WORLD, -1)


def _bf16_close(got, want, slack):
    """|got - want| <= one bf16 ulp of ``want`` + ``slack`` elementwise:
    two masters ``slack`` apart, each rounded to bf16."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-38))) - 7)
    bad = np.abs(got - want) > ulp + slack
    assert not bad.any(), (int(bad.sum()), got[bad][:5], want[bad][:5])


# -- the counterparts of tests/test_dp.py --------------------------------------------
def test_torch_dp_step_matches_one_process_trainer(gloo8, inputs):
    """8 ranks of the DP step against the port's one-process step on the
    whole batch, from the same state (tests/test_dp.py's bounds)."""
    tcfg, opt = inputs["config"], OptimizerConfig(**OPT)
    state = {"params": _clone(inputs["params"])}
    state["opt"] = init_opt_state(state["params"], opt)
    step = build_train_step(tcfg, opt)
    batch = {"tokens": torch.from_numpy(inputs["tokens"]).long()}
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    want = flatten_params(state["params"], 1)[0].numpy()
    for out in gloo8:
        got = out["plain"]
        np.testing.assert_allclose(got["losses"], losses, atol=LOSS_ATOL)
        np.testing.assert_allclose(got["params"], want, **PARAM_TOL)
        assert got["step"] == STEPS and got["dtypes"] == {"torch.bfloat16"}


def test_torch_dp_compressed_training_converges(gloo8):
    for out in gloo8:
        losses = out["converge"]["losses"]
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0] - CONVERGE_DROP, losses


def test_torch_dp_ranks_hold_one_model(gloo8):
    """Every rank ends with the same parameters, and its own shard."""
    for out in gloo8[1:]:
        for name in ("plain", "converge", *("jax_" + n for n in JAX_CASES)):
            np.testing.assert_array_equal(out[name]["params"],
                                          gloo8[0][name]["params"])
            assert out[name]["master"].size == gloo8[0][name]["master"].size


# -- against the reference's DP step -----------------------------------------------
def _held(got, want, tol, share, part):
    """Every element of ``got`` within ``tol`` of ``want`` but at most a
    ``share`` of them, which stay within ``part``; returns those."""
    d = np.abs(np.asarray(got, np.float64) - want)
    off = d > tol
    assert off.mean() <= share, (int(off.sum()), d.size, d.max())
    assert d.max() <= part, d.max()
    return off


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_torch_dp_step_matches_the_reference(gloo8, ref, name):
    """Each rank's shard of the master (and with int8 of m), and the
    gathered parameters, against the reference's after 3 steps (module docstring:
    a share of the elements, whose gradients cancel to round-off or, with
    int8, whose codes round the other way, part as far as two AdamW
    trajectories can)."""
    dtype, comp = JAX_CASES[name]
    _, tcfg = _configs(dtype, "float32")
    np.testing.assert_allclose([o["jax_" + name]["losses"] for o in gloo8],
                               np.broadcast_to(ref[name + "/losses"],
                                               (WORLD, STEPS)),
                               rtol=1e-5)
    master = _ref_flat(ref, name, "master", dtype, tcfg)
    m = _ref_flat(ref, name, "m", dtype, tcfg)
    scale = float(np.abs(master).max())
    part = 2 * STEPS * OPT["lr"] * (ADAM_RATIO + JAX_DECAY * scale)
    share = OFF_SHARE[comp]
    off = []
    for r, out in enumerate(gloo8):
        got = out["jax_" + name]
        off.append(_held(got["master"], master[r], MASTER_TOL * scale,
                         share, part))
        if comp == "int8":
            # one quantum: the largest shared scale of the three steps
            assert np.abs(got["m"] - m[r]).max() <= got["quantum"]
    jleaves = [ref[f"{name}/param/{i}"] for i in range(N_LEAVES)]
    want, _ = flatten_params(_to_port(jleaves, "float32", _configs(
        "float32")[1]), WORLD)
    keep = ~np.concatenate(off)
    got = gloo8[0]["jax_" + name]["params"]
    n = got.size
    _bf16_close(got[keep[:n]], want.numpy()[:n][keep[:n]],
                MASTER_TOL * scale)
    assert gloo8[0]["jax_" + name]["dtypes"] == {"torch." + dtype}
    # the all-gather runs in bf16: fp32 parameters hold bf16 values too
    g = torch.from_numpy(got)
    assert torch.equal(g, g.bfloat16().float())


# -- the flat vector, a group of one, no group --------------------------------------
@pytest.mark.parametrize("world", [1, 3, 8, 7919])
def test_torch_flatten_round_trip(inputs, world):
    params = inputs["params"]
    flat, meta = flatten_params(params, world)
    n = sum(p.numel() for p in tree_leaves(params))
    assert flat.dtype == torch.float32
    assert flat.numel() % world == 0 and flat.numel() - n == meta[2] < world
    assert not flat[n:].any()
    back = unflatten_params(flat, meta)
    assert [p.dtype for p in tree_leaves(back)] == \
        [p.dtype for p in tree_leaves(params)]
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b)
    assert torch.equal(unflatten_params(flat[:n], meta)["embed"]["tok"],
                       params["embed"]["tok"])


def test_torch_dp_on_a_group_of_one(inputs, gloo8, tmp_path):
    """World 1 runs the same collectives on one gloo rank, on the whole
    batch: the 8-rank step's numbers within the reference's bounds."""
    (one,) = spawn_ranks(_one_rank, 1, (inputs["params"], inputs["tokens"]),
                         tmp_path)
    np.testing.assert_allclose(one["losses"], gloo8[0]["plain"]["losses"],
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(one["params"], gloo8[0]["plain"]["params"],
                               **PARAM_TOL)
    n = sum(p.numel() for p in tree_leaves(inputs["params"]))
    assert one["master"].size == n


def test_torch_dp_without_a_group_is_refused(inputs):
    _, tcfg = _configs()
    with pytest.raises(ValueError, match="process group"):
        build_dp_train_step(tcfg, OptimizerConfig(**OPT), None)
    with pytest.raises(ValueError, match="process group"):
        init_dp_opt_state(inputs["params"], None, OptimizerConfig(**OPT))
