"""The port's mesh (``repro_torch.parallel.sharding``, ``training
.shardings_for``, ZeRO-1 in ``optim/adamw.py``, head padding) on 8
spawned gloo ranks, against the port's one-process step and serving path
and against the reference's GSPMD step.

The ranks are spawned once for the module (``gloo8``) and run every case;
the tests read their results.

* Step parity: each family's ``reduced()`` in fp32, its state placed by
  ``shardings_for`` with ``zero1=True`` (the reference's default), on the
  meshes (pod 2, data 2, model 2), (data 4, model 2) and (data 2, model
  4), 3 steps against the port's one-process step from the same state:
  tests/test_dp.py's bounds, the losses within 1e-2 and the parameters
  within rtol 2e-2 and atol 2e-3.
* ZeRO-1 memory: on each rank every leaf of 'm', 'v' and 'master' holds
  1/n of its parameter's elements on this rank, n the product of the
  ZeRO axes ``zero1_state_specs`` added to it (1/data on a leaf that
  'data' divides), and ``init_opt_state`` on the placed parameters places
  the state as ``shardings_for`` does.
* Serving: each family's prefill and 4 decode steps on caches placed by
  ``cache_specs``, on (data 2, model 4), equal to the unsharded ones
  within 1e-5 of the largest logit.
* Head padding: a config of 6 heads (2 KV heads) with
  ``pad_attention_heads`` on (data 2, model 4): the attention runs on 8
  heads, 2 on each rank of 'model', and the prefill's and the decode's
  logits equal the unpadded, unsharded ones within 1e-5.
* ``make_worker_mesh`` over the 8 processes, and a dimension over ('pod',
  'data') split pod-major, as the reference's tuple is.
* Against JAX: the reference's ``build_train_step`` ``jax.jit``-ed with
  ``shardings_for``'s specs as ``in_shardings``/``out_shardings`` on a
  (2, 2, 2) mesh of 8 virtual CPU devices (tests/test_multidevice.py's
  subprocess), for internlm2-1.8b and granite-moe-3b-a800m at
  ``reduced()`` in fp32, 3 steps, and the port's sharded step on the same
  mesh of gloo ranks from the same parameters (``models/convert.py``):
  the same bounds.
"""
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_get_config
from repro.models.registry import get_model as jax_get_model
from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig, ShapeConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model
from repro_torch.training import build_train_step, init_state
from repro_torch.utils import tree_leaves
from tests.test_multidevice import run_with_devices
from tests.test_torch_bridge import spawn_ranks

WORLD, B, S, STEPS, DECODE = 8, 8, 16, 3, 4
FAMILIES = {"dense": "internlm2-1.8b", "moe": "granite-moe-3b-a800m",
            "hybrid": "recurrentgemma-2b", "audio": "whisper-medium",
            "ssm": "rwkv6-7b", "vlm": "llava-next-34b"}
MESHES = {"pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model")),
          "data4_model2": ((4, 2), ("data", "model")),
          "data2_model4": ((2, 4), ("data", "model"))}
SERVE_MESH = "data2_model4"
JAX_ARCHS = ("internlm2-1.8b", "granite-moe-3b-a800m")
LOSS_ATOL, PARAM_TOL = 1e-2, dict(rtol=2e-2, atol=2e-3)   # test_dp.py:34-44
LOGIT_TOL = 1e-5          # of the largest logit
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=50, grad_clip=1.0)
# 6 heads over a 'model' axis of 4, padded to 8
PAD_HEADS, PAD_KV = 6, 2


def _config(arch, **kw):
    return get_config(arch, reduced=True).replace(
        dtype="float32", param_dtype="float32", **kw)


def _batch(config, seed=7):
    """The family's batch of B rows: S tokens, and the frames or image
    embeddings an audio or vlm model reads."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, config.vocab_size, (B, S)))}
    if config.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, config.encoder_seq, config.d_model), np.float32))
    if config.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, config.num_image_tokens, config.d_model), np.float32))
    return batch


def _state(config, zero1):
    return init_state(torch.Generator().manual_seed(0), config,
                      OptimizerConfig(**OPT, zero1=zero1))


def _numpy_leaves(tree, path=""):
    """{path: the leaf as fp32 numpy}, whatever the trees' key order."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _numpy_leaves(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _numpy_leaves(sub, f"{path}/{i}").items()}
    return {path: tree.detach().float().numpy()}


# -- the ranks ---------------------------------------------------------------------
def _sharded_steps(mesh, config, state, batch):
    """STEPS sharded steps from ``state`` (plain), placed by
    ``shardings_for``; returns the losses, the gathered parameters, and
    per leaf of the state the local element counts (ZeRO-1)."""
    from repro_torch.optim import init_opt_state
    from repro_torch.parallel.sharding import gather_tree, use_mesh
    from repro_torch.training import shardings_for

    opt = OptimizerConfig(**OPT, zero1=True)
    cell = shardings_for(config, ShapeConfig("cell", S, B, "train"), mesh,
                         opt)
    placed = cell.place(state, cell.state_specs)
    again = init_opt_state(placed["params"], opt)
    same = all(tuple(a.placements) == tuple(b.placements)
               for k in ("m", "v", "master")
               for a, b in zip(tree_leaves(placed["opt"][k]),
                               tree_leaves(again[k])))
    step = build_train_step(config, opt)
    losses = []
    with use_mesh(cell.mesh, cell.rules):
        for _ in range(STEPS):
            placed, metrics = step(placed, cell.place(batch,
                                                      cell.batch_specs))
            losses.append(float(metrics["loss"]))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    zero = []
    for p, ps, zs, *leaves in zip(
            tree_leaves(placed["params"]), _spec_leaves(cell.param_specs),
            _spec_leaves(cell.state_specs["opt"]["m"]),
            *(tree_leaves(placed["opt"][k]) for k in ("m", "v", "master"))):
        added = [a for part in zs if part is not None
                 for a in (part if isinstance(part, tuple) else (part,))
                 if a not in {b for q in ps if q is not None
                              for b in (q if isinstance(q, tuple) else (q,))}]
        zero.append({"param": p.to_local().numel(),
                     "state": [t.to_local().numel() for t in leaves],
                     "n": int(np.prod([sizes[a] for a in added])),
                     "data": "data" in added})
    return {"losses": losses, "same_as_init": same, "zero": zero,
            "params": _numpy_leaves(gather_tree(placed["params"]))}


def _spec_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _spec_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]


def _serve(mesh, config, params, batch):
    """The prefill and DECODE greedy steps on ``mesh`` (the parameters and
    the batch placed, the cache placed by the prefill), the logits
    gathered; and the heads the attention ran on."""
    from repro_torch.models import attention
    from repro_torch.parallel.sharding import use_mesh
    from repro_torch.training import build_serve_fns, shardings_for

    cell = shardings_for(config, ShapeConfig("cell", S, B, "prefill"), mesh)
    params = cell.place(params, cell.param_specs)
    prefill, decode = build_serve_fns(config)
    heads, core = set(), attention._local_core

    def counted(q, *args):
        heads.add((q.shape[2], q.to_local().shape[2]))
        return core(q, *args)

    attention._local_core = counted
    try:
        with use_mesh(cell.mesh, cell.rules), torch.no_grad():
            logits, cache = prefill(params, cell.place(batch,
                                                       cell.batch_specs),
                                    S + DECODE + 16)
            out = [logits.full_tensor().numpy()]
            for _ in range(DECODE):
                tok = torch.argmax(logits.full_tensor()[:, -1], -1)[:, None]
                logits, cache = decode(params, tok, cache)
                out.append(logits.full_tensor().numpy())
    finally:
        attention._local_core = core
    return {"logits": out, "heads": sorted(heads)}


def _jax_case(mesh, arch, params):
    config = _config(arch)
    return _sharded_steps(mesh, config,
                          {"params": params, "opt": _opt_of(params)},
                          _batch(config))


def _opt_of(params):
    from repro_torch.optim import init_opt_state
    return init_opt_state(params, OptimizerConfig(**OPT, zero1=True))


def _mesh_rank(rank, world, jax_params):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.bridge import make_worker_mesh

    workers = make_worker_mesh("cpu")
    out = {"workers": (workers.mesh_dim_names, workers.size(),
                       workers.get_coordinate())}
    for name, (shape, names) in MESHES.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        for family, arch in FAMILIES.items():
            config = _config(arch)
            out[name, family] = _sharded_steps(
                mesh, config, _state(config, True), _batch(config))
        if name == SERVE_MESH:
            for family, arch in FAMILIES.items():
                config = _config(arch)
                out["serve", family] = _serve(
                    mesh, config, _state(config, False)["params"],
                    _batch(config))
            config = _config("internlm2-1.8b", num_heads=PAD_HEADS,
                             num_kv_heads=PAD_KV, pad_attention_heads=True)
            out["pad"] = _serve(mesh, config,
                                _state(config, False)["params"],
                                _batch(config))
        if name == "pod2_data2_model2":
            from repro_torch.parallel.sharding import P, distribute, \
                placements
            x = torch.arange(8.0)
            d = distribute(x, mesh, placements(P(("pod", "data")), mesh))
            out["pod_major"] = (mesh.get_coordinate(), d.to_local().tolist(),
                                d.full_tensor().tolist())
            for arch in JAX_ARCHS:
                out["jax", arch] = _jax_case(mesh, arch, jax_params[arch])
    if rank:
        for value in out.values():
            if isinstance(value, dict):
                value.pop("params", None)
                value.pop("logits", None)
    return out


# -- the reference, on 8 virtual devices -------------------------------------------
_REFERENCE = """
    import jax, numpy as np
    from repro.configs import get_config
    from repro.configs.base import OptimizerConfig, ShapeConfig
    from repro.parallel.sharding import use_mesh
    from repro.training import (build_train_step, init_state, rules_for,
                                shardings_for)
    from repro.utils import make_mesh_compat

    mesh = make_mesh_compat((2, 2, 2), ("pod", "data", "model"))
    opt = OptimizerConfig(**{opt!r})
    out = {{}}
    for arch in {archs!r}:
        cfg = get_config(arch, reduced=True).replace(
            dtype="float32", param_dtype="float32")
        cell = shardings_for(cfg, ShapeConfig("cell", {s}, {b}, "train"),
                             mesh, opt)
        tokens = np.random.default_rng(7).integers(
            0, cfg.vocab_size, ({b}, {s})).astype(np.int32)
        with use_mesh(mesh, rules_for(cfg)):
            step = jax.jit(build_train_step(cfg, opt),
                           in_shardings=(cell.sharding(cell.state_specs),
                                         cell.sharding(cell.batch_specs)),
                           out_shardings=(cell.sharding(cell.state_specs),
                                          None))
            state = jax.device_put(init_state(jax.random.PRNGKey(0), cfg,
                                              opt),
                                   cell.sharding(cell.state_specs))
            losses = []
            for _ in range({steps}):
                state, m = step(state, {{"tokens": tokens}})
                losses.append(float(m["loss"]))
        out[arch + "/losses"] = np.asarray(losses)
        for i, leaf in enumerate(jax.tree_util.tree_leaves(state["params"])):
            out[arch + "/param/" + str(i)] = np.asarray(leaf, np.float32)
    np.savez({path!r}, **out)
    print("OK")
"""


def _jax_init(arch):
    jcfg = jax_get_config(arch, reduced=True).replace(
        dtype="float32", param_dtype="float32")
    return jax_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def jax_params():
    return {arch: params_from_jax(jax.tree_util.tree_map(
        np.asarray, _jax_init(arch)), _config(arch)) for arch in JAX_ARCHS}


@pytest.fixture(scope="module")
def gloo8(jax_params, tmp_path_factory):
    return spawn_ranks(_mesh_rank, WORLD, (jax_params,),
                       tmp_path_factory.mktemp("mesh8"), timeout=600)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh_ref") / "ref.npz")
    run_with_devices(textwrap.dedent(_REFERENCE).format(
        opt={**OPT, "zero1": True}, archs=JAX_ARCHS, b=B, s=S, steps=STEPS,
        path=path))
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _one_process(config, state, batch):
    step = build_train_step(config, OptimizerConfig(**OPT, zero1=False))
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses, _numpy_leaves(state["params"])


def _held(got, losses, params):
    np.testing.assert_allclose(got["losses"], losses, atol=LOSS_ATOL)
    assert set(got["params"]) == set(params)
    for path, want in params.items():
        np.testing.assert_allclose(got["params"][path], want, **PARAM_TOL,
                                   err_msg=path)


# -- step parity and ZeRO-1 -----------------------------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_torch_sharded_step_matches_one_process(gloo8, family, mesh):
    """A zero1=True step on the mesh against the one-process step
    (tests/test_dp.py's bounds), from the same state; every rank saw the
    same losses."""
    config = _config(FAMILIES[family])
    losses, params = _one_process(config, _state(config, False),
                                  _batch(config))
    _held(gloo8[0][mesh, family], losses, params)
    for out in gloo8[1:]:
        assert out[mesh, family]["losses"] == gloo8[0][mesh, family]["losses"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_torch_zero1_state_is_one_data_shard(gloo8, mesh):
    """Every state leaf holds 1/n of its parameter's local elements, n
    the ZeRO axes' sizes, on every rank, and every leaf that 'data'
    divides takes it; ``init_opt_state`` on placed parameters places the
    state as ``shardings_for`` does."""
    data = dict(zip(MESHES[mesh][1], MESHES[mesh][0]))["data"]
    for out in gloo8:
        for family in FAMILIES:
            got = out[mesh, family]
            assert got["same_as_init"]
            sharded = 0
            for leaf in got["zero"]:
                assert all(n * leaf["n"] == leaf["param"]
                           for n in leaf["state"]), (family, leaf)
                if leaf["data"]:
                    sharded += 1
                    assert leaf["n"] % data == 0
            assert sharded >= len(got["zero"]) // 2, (family, sharded)


# -- serving and head padding ----------------------------------------------------
def _served_unsharded(config, params, batch):
    model = get_model(config)
    with torch.no_grad():
        logits, cache = model.prefill(params, batch, config,
                                      max_len=S + DECODE + 16)
        out = [logits.numpy()]
        for _ in range(DECODE):
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            logits, cache = model.decode_step(params, tok, cache, config)
            out.append(logits.numpy())
    return out


def _logits_close(got, want):
    for a, b in zip(got, want, strict=True):
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_TOL * scale)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_torch_sharded_serving_matches_unsharded(gloo8, family):
    config = _config(FAMILIES[family])
    want = _served_unsharded(config, _state(config, False)["params"],
                             _batch(config))
    _logits_close(gloo8[0]["serve", family]["logits"], want)


def test_torch_head_padding_runs_padded_heads_and_matches(gloo8):
    """6 heads on a 'model' axis of 4: the attention runs on 8 heads, 2 a
    rank, and the logits equal the unpadded, unsharded ones."""
    config = _config("internlm2-1.8b", num_heads=PAD_HEADS,
                     num_kv_heads=PAD_KV, pad_attention_heads=True)
    want = _served_unsharded(config, _state(config, False)["params"],
                             _batch(config))
    _logits_close(gloo8[0]["pad"]["logits"], want)
    for out in gloo8:
        assert out["pad"]["heads"] == [(8, 2)]


# -- against the reference's GSPMD step ------------------------------------------
def _reference_params(reference, arch, config):
    jp = _jax_init(arch)
    treedef = jax.tree_util.tree_structure(jp)
    n = len(jax.tree_util.tree_leaves(jp))
    leaves = [reference[f"{arch}/param/{i}"] for i in range(n)]
    return _numpy_leaves(params_from_jax(
        jax.tree_util.tree_unflatten(treedef, leaves), config))


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_torch_sharded_step_matches_the_reference_gspmd_step(
        gloo8, reference, arch):
    config = _config(arch)
    _held(gloo8[0]["jax", arch], reference[arch + "/losses"],
          _reference_params(reference, arch, config))


def test_torch_worker_mesh_spans_the_group(gloo8):
    """``make_worker_mesh``: one 'workers' axis over the 8 processes, rank
    r at coordinate r; refused without a process group."""
    from repro_torch.core.bridge import make_worker_mesh

    for r, out in enumerate(gloo8):
        names, size, coordinate = out["workers"]
        assert (names, size, list(coordinate)) == (("workers",), WORLD, [r])
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="default group"):
        make_worker_mesh("cpu")


def test_torch_pod_data_sharding_is_pod_major(gloo8):
    """A dimension over ('pod', 'data') on (2, 2, 2): the rank at (pod p,
    data d) holds block 2p + d of 4, the reference's order, and the
    blocks gather back whole."""
    for out in gloo8:
        (p, d, _), local, full = out["pod_major"]
        block = 2 * p + d
        assert local == [2.0 * block, 2.0 * block + 1]
        assert full == [float(i) for i in range(8)]
