"""The all-to-all MoE (``padded_experts``, ``moe_layer_a2a`` and the
block's ``_moe_impl: "a2a"`` branch) in the port, on 8 spawned gloo
ranks, against the reference's on 8 virtual CPU devices and against the
port's own scatter dispatch.

The ranks are spawned once for the module (``gloo8``) and run every case
on a (data 4, model 2) mesh; the reference runs once in a subprocess
(``reference``, tests/test_multidevice.py's ``run_with_devices``).

* ``padded_experts`` and ``init_moe``'s tree shapes for every arch, with
  and without the a2a overrides, against the reference's.
* Expert ownership: an a2a config's expert leaves placed by
  ``shardings_for`` on (data 4, model 2); rank (d, m) holds expert block
  m·4 + d, the reference's ``NamedSharding`` block map; and
  ``params_from_jax`` carries the padded tree across unchanged.
* ``moe_layer_a2a`` on granite-moe-3b-a800m's ``reduced()`` layer, 4
  experts padded to 8, in fp32, at capacity factor 4.0 (drop-free) and
  1.25 (slots drop), against the JAX ``moe_layer_a2a`` on the same
  numpy weights and input: output and aux loss within 1e-5.
* tests/test_multidevice.py:205's check: the a2a output equal to the
  scatter dispatch (``moe_layer``, one process, the unpadded experts) at
  4.0 within rtol/atol 2e-3, aux within 1e-5; and the gradients of the
  input, the router and every expert the same within 1e-5 of each
  leaf's largest magnitude, the padded experts' zero.
* Each fallback to ``moe_layer``: no mesh; no 'model' or 'data' axis
  larger than 1 (a (pod 8, data 1, model 1) mesh); E_pad not a multiple
  of the expert group (4 unpadded experts over 8 ranks).
* granite's ``reduced()`` prefill with the a2a branch on the mesh,
  ``shardings_for``'s cell, against the JAX model's under the same mesh
  (fp32, 1e-5 of the largest logit), and the decode, whose one position
  does not split over 'model': the reference's shard_map refuses it with
  ``ValueError``, and so does the port, with its reason
  (``A2A_REFUSED``).
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models.registry import get_model as jax_get_model
from repro_torch.configs import REFERENCE_ARCHS, get_config
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import param_shapes
from tests.test_multidevice import run_with_devices
from tests.test_torch_bridge import spawn_ranks

WORLD, MESH = 8, ((4, 2), ("data", "model"))
ARCH = "granite-moe-3b-a800m"
A2A = {"_moe_impl": "a2a", "_moe_pad_experts": 8}
FACTORS = (4.0, 1.25)
B, S = 8, 16
TOL = 1e-5
SCATTER_TOL = dict(rtol=2e-3, atol=2e-3)      # tests/test_multidevice.py:240


def _config(**kw):
    return get_config(ARCH, reduced=True).replace(
        dtype="float32", param_dtype="float32", **kw)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- the reference, on 8 virtual devices ------------------------------------------
_REFERENCE = """
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.models import moe as moe_lib
    from repro.models.registry import get_model
    from repro.parallel.sharding import ShardingRules, use_mesh
    from repro.utils import make_mesh_compat

    mesh = make_mesh_compat({shape!r}, {names!r})
    out = {{}}
    base = get_config({arch!r}, reduced=True).replace(
        dtype="float32", param_dtype="float32")
    cfg = base.replace(sharding_overrides={a2a!r})
    rules = ShardingRules(overrides=dict(cfg.sharding_overrides))
    pa, _ = moe_lib.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
    for k, v in pa.items():
        out["moe/" + k] = np.asarray(v)
    x = np.random.default_rng(1).standard_normal(
        ({b}, {s}, cfg.d_model)).astype(np.float32)
    for f in {factors!r}:
        c = cfg.replace(capacity_factor=f)
        with use_mesh(mesh, rules):
            y, aux = jax.jit(lambda x, p: moe_lib.moe_layer_a2a(x, p, c))(
                x, pa)
        out[f"a2a/{{f}}/y"] = np.asarray(y)
        out[f"a2a/{{f}}/aux"] = np.asarray(aux)
    # the block map of whole experts: the index each device's block starts at
    imap = NamedSharding(mesh, P(("model", "data"))).devices_indices_map(
        pa["w_up"].shape)
    out["block_start"] = np.array([[imap[dev][0].start or 0 for dev in row]
                                   for row in mesh.devices])
    # padded weights without a mesh: moe_layer's products refuse them
    try:
        moe_lib.moe_layer_a2a(x, pa, cfg)
        out["unmeshed_padded_refused"] = np.array(False)
    except Exception:
        out["unmeshed_padded_refused"] = np.array(True)
    # the model: prefill on the mesh, then a decode step
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(0), cfg)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
        out[f"param/{{i}}"] = np.asarray(leaf)
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, ({b}, {s})).astype(np.int32)
    with use_mesh(mesh, rules):
        logits, cache = jax.jit(lambda p, t: model.prefill(
            p, {{"tokens": t}}, cfg, {s} + 1))(params, tokens)
        out["prefill"] = np.asarray(logits)
        try:
            jax.jit(lambda p, t, c: model.decode_step(p, t, c, cfg))(
                params, tokens[:, :1], cache)
            out["decode_refused"] = np.array("")
        except ValueError as e:
            out["decode_refused"] = np.array(type(e).__name__)
    np.savez({path!r}, **out)
    print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("a2a_ref") / "ref.npz")
    run_with_devices(textwrap.dedent(_REFERENCE).format(
        shape=MESH[0], names=MESH[1], arch=ARCH, a2a=A2A, b=B, s=S,
        factors=FACTORS, path=path))
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _reference_tree(reference):
    """The reference's parameters of the a2a model, numpy leaves."""
    jcfg = jax_get_config(ARCH, reduced=True).replace(
        dtype="float32", param_dtype="float32", sharding_overrides=A2A)
    shapes = jax.eval_shape(lambda: jax_get_model(jcfg).init(
        jax.random.PRNGKey(0), jcfg))
    treedef = jax.tree_util.tree_structure(shapes)
    return jax.tree_util.tree_unflatten(treedef, [
        reference[f"param/{i}"] for i in range(treedef.num_leaves)])


def _scatter_params(reference):
    """The layer's weights, the padded experts cut off: what the scatter
    dispatch runs on."""
    E = get_config(ARCH, reduced=True).num_experts
    return {k: torch.from_numpy(reference["moe/" + k])[:E]
            if k != "router" else torch.from_numpy(reference["moe/" + k])
            for k in ("router", "w_gate", "w_up", "w_down")}


# -- the ranks ---------------------------------------------------------------------
def _moe_grads(mesh, config, pa, x, cot):
    """The gradients of sum(out · cot) + aux with respect to x and every
    MoE leaf: under ``mesh`` through ``moe_layer_a2a`` on leaves placed by
    ``moe_specs``, else through ``moe_layer`` on plain ones. Returns
    (out, aux, {name: gradient}) as plain tensors."""
    from repro_torch.parallel.sharding import (P, distribute, placements,
                                               tree_specs_shaped, use_mesh,
                                               whole)
    from repro_torch.training import rules_for

    rules = rules_for(config)
    with use_mesh(mesh, rules):
        if mesh is None:
            live = {k: v.clone().requires_grad_() for k, v in pa.items()}
            xl = x.clone().requires_grad_()
            out, aux = tmoe.moe_layer(xl, live, config)
        else:
            specs = tree_specs_shaped(tmoe.moe_specs(config), pa, mesh,
                                      rules)
            live = {k: distribute(v, mesh, placements(specs[k], mesh))
                    .requires_grad_() for k, v in pa.items()}
            xl = distribute(x, mesh, placements(P("data", "model"), mesh)
                            ).requires_grad_()
            out, aux = tmoe.moe_layer_a2a(xl, live, config)
        grads = torch.autograd.grad((out * cot).sum() + aux,
                                    [xl] + list(live.values()))
    return (whole(out).detach(), whole(aux).detach(),
            {n: whole(g).detach() for n, g in zip(["x"] + list(live),
                                                   grads)})


def _a2a_rank(rank, world, ref, params):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import OptimizerConfig, ShapeConfig
    from repro_torch.models import transformer
    from repro_torch.parallel.sharding import use_mesh, whole
    from repro_torch.training import shardings_for

    mesh = init_device_mesh("cpu", *MESH[:1], mesh_dim_names=MESH[1])
    out = {"coord": mesh.get_coordinate()}
    config = _config(sharding_overrides=A2A)
    pa = {k: torch.from_numpy(ref["moe/" + k]) for k in
          ("router", "w_gate", "w_up", "w_down")}
    x = torch.from_numpy(_normal(1, (B, S, config.d_model)))
    from repro_torch.training import rules_for
    rules = rules_for(config)

    # ownership: each expert's leaves filled with its index, placed by the
    # train cell's specs
    cell = shardings_for(config, ShapeConfig("cell", S, B, "train"), mesh,
                         OptimizerConfig())
    ids = {k: torch.arange(v.shape[0], dtype=torch.float32).view(
        -1, 1, 1).expand(v.shape).contiguous() for k, v in pa.items()
        if k != "router"}
    specs = cell.param_specs["layers"][0]["moe"]
    placed = cell.place(ids, {k: specs[k] for k in ids})
    out["own"] = {k: sorted(set(v.to_local()[:, 0, 0].tolist()))
                  for k, v in placed.items()}

    # the layer at each capacity factor, plain inputs on every rank
    for f in FACTORS:
        with use_mesh(mesh, rules):
            y, aux = tmoe.moe_layer_a2a(x, pa, config.replace(
                capacity_factor=f))
        out["a2a", f] = (whole(y), whole(aux))

    # gradients at 4.0, against the scatter dispatch in one process
    cot = torch.from_numpy(_normal(3, (B, S, config.d_model)))
    free = config.replace(capacity_factor=4.0)
    out["grads"] = _moe_grads(mesh, free, pa, x, cot)

    # the fallbacks, on the unpadded experts: E_pad = E = 4
    plain = _config(capacity_factor=4.0,
                    sharding_overrides={"_moe_impl": "a2a"})
    unpadded = {k: v[:plain.num_experts] if k != "router" else v
                for k, v in pa.items()}
    flat = init_device_mesh("cpu", (8, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    fall = {"no mesh": tmoe.moe_layer_a2a(x, unpadded, plain)}
    with use_mesh(flat, rules):
        fall["no expert axis"] = tmoe.moe_layer_a2a(x, unpadded, plain)
    with use_mesh(mesh, rules):
        fall["E_pad % n"] = tmoe.moe_layer_a2a(x, unpadded, plain)
    out["fallback"] = {k: (whole(y), whole(a)) for k, (y, a) in fall.items()}
    out["fallback_want"] = tmoe.moe_layer(x, unpadded, plain)

    # the model: the prefill cell, then a decode step
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, config.vocab_size, (B, S)))
    cell = shardings_for(config, ShapeConfig("prefill", S, B, "prefill"),
                         mesh)
    with use_mesh(cell.mesh, cell.rules):
        logits, cache = transformer.prefill(
            cell.place(params, cell.param_specs),
            cell.place({"tokens": tokens}, cell.batch_specs), config, S + 1)
        out["prefill"] = whole(logits)
        try:
            transformer.decode_step(cell.place(params, cell.param_specs),
                                    tokens[:, :1], cache, config)
            out["decode"] = None
        except ValueError as e:
            out["decode"] = str(e)
    if rank:
        for key in ("grads", "prefill", "fallback", "fallback_want",
                    ("a2a", 4.0), ("a2a", 1.25)):
            out.pop(key)
    return _numpy(out)


def _numpy(tree):
    """Tensors as numpy arrays: a result crosses processes after its
    sender exits, where a shared tensor would not."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return tree


@pytest.fixture(scope="module")
def gloo8(reference, tmp_path_factory):
    params = params_from_jax(_reference_tree(reference),
                             _config(sharding_overrides=A2A))
    return spawn_ranks(_a2a_rank, WORLD, (reference, params),
                       tmp_path_factory.mktemp("a2a8"), timeout=600)


# -- host only -----------------------------------------------------------------------
@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
@pytest.mark.parametrize("overrides", [{}, A2A, {"_moe_impl": "a2a"},
                                       {"_moe_pad_experts": 8}])
def test_torch_padded_experts_and_init_shapes_match_the_reference(
        arch, overrides):
    """E_pad, and the MoE tree's shapes (the router (D, E), the experts
    (E_pad, ...)), as the reference's: padding only on the a2a path."""
    jcfg = jax_get_config(arch, reduced=True).replace(
        sharding_overrides=overrides)
    tcfg = get_config(arch, reduced=True).replace(
        sharding_overrides=overrides)
    assert tmoe.padded_experts(tcfg) == jmoe.padded_experts(jcfg)
    if tcfg.num_experts == 0:
        return
    jshapes = jax.eval_shape(lambda: jmoe.init_moe(
        jax.random.PRNGKey(0), jcfg, jnp.float32)[0])
    tshapes = param_shapes(tcfg)["layers"][0]["moe"]
    assert {k: tuple(v.shape) for k, v in tshapes.items()} == {
        k: tuple(v.shape) for k, v in jshapes.items()}


def test_torch_model_major_placements_round_trip():
    """('model', 'data') on a (data 4, model 2) mesh: 'model' a Shard,
    'data' a _StridedShard inside its blocks, and back to the same spec;
    a size-1 axis replicates; any other tuple against the mesh's order is
    refused with its message."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    from repro_torch.parallel.sharding import P, placements, spec_of

    class Mesh:            # what ``placements`` reads of a DeviceMesh
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 4, 2)

    spec = P(("model", "data"), None, "pod")
    got = placements(spec, Mesh())
    assert got == (Shard(2), _StridedShard(0, split_factor=2), Shard(0))
    assert tuple(spec_of(got, Mesh())) == tuple(spec)
    Mesh.shape = (2, 1, 2)
    assert placements(P(("model", "data")), Mesh()) == (
        Replicate(), Replicate(), Shard(0))
    with pytest.raises(ValueError, match="not in the mesh's order"):
        placements(P(("model", "pod")), Mesh())


def test_torch_padded_tree_converts_unchanged(reference):
    """``params_from_jax`` carries the reference's padded tree across:
    every layer's MoE leaves equal to the reference's, 8 experts behind a
    router of 4."""
    jtree = _reference_tree(reference)
    config = _config(sharding_overrides=A2A)
    params = params_from_jax(jtree, config)
    for i, layer in enumerate(params["layers"]):
        for k, v in layer["moe"].items():
            np.testing.assert_array_equal(v.numpy(),
                                          jtree["layers"]["moe"][k][i])
    assert tuple(params["layers"][0]["moe"]["w_up"].shape)[0] == 8
    assert tuple(params["layers"][0]["moe"]["router"].shape)[1] == 4


# -- on the ranks ---------------------------------------------------------------------
def test_torch_experts_are_owned_model_major(gloo8, reference):
    """Rank (d, m) holds whole experts [(m·|data| + d)·e_per, ...): the
    reference's block map of P(('model', 'data')), on every expert leaf."""
    starts = reference["block_start"]
    for out in gloo8:
        d, m = out["coord"]
        assert m * 4 + d == starts[d, m]
        for leaf, held in out["own"].items():
            assert held == [float(starts[d, m])], leaf


@pytest.mark.parametrize("factor", FACTORS)
def test_torch_a2a_matches_the_reference_a2a(gloo8, reference, factor):
    """The port's ``moe_layer_a2a`` on 8 ranks against the JAX one on 8
    devices: the same weights and input, slots dropped at 1.25."""
    y, aux = gloo8[0]["a2a", factor]
    want = reference[f"a2a/{factor}/y"]
    np.testing.assert_allclose(y, want,
                               atol=TOL * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(float(aux),
                               float(reference[f"a2a/{factor}/aux"]),
                               rtol=TOL)


def test_torch_a2a_matches_the_scatter_dispatch(gloo8, reference):
    """tests/test_multidevice.py:205 in the port: at 4.0 neither path
    drops, so the a2a output is the scatter dispatch's."""
    config = _config(capacity_factor=4.0)
    y, aux, _ = gloo8[0]["grads"]
    x = torch.from_numpy(_normal(1, (B, S, config.d_model)))
    want, aux0 = tmoe.moe_layer(x, _scatter_params(reference), config)
    np.testing.assert_allclose(y, want.numpy(), **SCATTER_TOL)
    np.testing.assert_allclose(float(aux), float(aux0), rtol=1e-5)


def test_torch_a2a_gradients_match_the_scatter_dispatch(gloo8, reference):
    """The gradients of sum(out · cot) + aux through the all-to-alls
    against the scatter dispatch in one process: the input's, the
    router's, each routed expert's within 1e-5 of its largest magnitude;
    the padded experts, which no token reaches, zero."""
    config = _config(capacity_factor=4.0)
    x = torch.from_numpy(_normal(1, (B, S, config.d_model)))
    cot = torch.from_numpy(_normal(3, (B, S, config.d_model)))
    _, _, got = gloo8[0]["grads"]
    _, _, want = _moe_grads(None, config, _scatter_params(reference), x,
                            cot)
    E = config.num_experts
    for name, g in want.items():
        have = got[name][:E] if name.startswith("w_") else got[name]
        np.testing.assert_allclose(have, g.numpy(), rtol=0,
                                   atol=TOL * float(g.abs().max()),
                                   err_msg=name)
        if name.startswith("w_"):
            assert not got[name][E:].any(), name


@pytest.mark.parametrize("case", ["no mesh", "no expert axis", "E_pad % n"])
def test_torch_a2a_falls_back_to_moe_layer(gloo8, case):
    """The reference's three fallbacks run ``moe_layer``: the same output
    and aux loss to the bit."""
    y, aux = gloo8[0]["fallback"][case]
    want, aux0 = gloo8[0]["fallback_want"]
    np.testing.assert_array_equal(y, want)
    assert float(aux) == float(aux0)


def test_torch_padded_weights_without_a_mesh_are_refused(reference):
    """Without a mesh both packages fall back to ``moe_layer``, whose
    products refuse a padded tree (E_pad experts against E routes)."""
    assert bool(reference["unmeshed_padded_refused"])
    config = _config(sharding_overrides=A2A)
    pa = {k: torch.from_numpy(reference["moe/" + k]) for k in
          ("router", "w_gate", "w_up", "w_down")}
    with pytest.raises(RuntimeError):
        tmoe.moe_layer_a2a(torch.from_numpy(_normal(1, (B, S, 64))), pa,
                           config)


def test_torch_a2a_prefill_matches_the_reference(gloo8, reference):
    """granite's ``reduced()`` prefill, the a2a branch in every block, on
    the (data 4, model 2) mesh: the last-token logits within 1e-5 of the
    largest of the JAX model's under the same mesh."""
    got = gloo8[0]["prefill"]
    want = reference["prefill"]
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(),
                               rtol=0)


def test_torch_a2a_decode_is_refused_as_the_reference_refuses_it(
        gloo8, reference):
    """A decode step's one position does not split over 'model' 2: the
    reference's shard_map raises ValueError, and the port raises it with
    its reason on every rank."""
    assert str(reference["decode_refused"]) == "ValueError"
    reason = tmoe.A2A_REFUSED.split("{")[0]
    for out in gloo8:
        assert out["decode"] is not None and out["decode"].startswith(reason)
