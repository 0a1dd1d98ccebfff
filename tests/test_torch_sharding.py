"""The port's logical-axis sharding (``repro_torch.parallel.sharding``),
its families' ``param_specs``/``cache_specs`` and ZeRO-1's state specs
(``repro_torch.optim.adamw``) against the JAX package's, on the host: no
process group, the meshes abstract (axis name -> size).

* The counterparts of the reference's five rules tests
  (tests/test_sharding_hlocost.py:21-62), and the port's own refusal of a
  "layers" rule.
* Every arch's full config, kimi-k2's overrides included, on meshes (1,
  1), (4, 2), (2, 4), (16, 16) and (2, 16, 16): ``tree_specs_shaped`` of
  the parameters (``param_shapes`` on the meta device) and of the decode
  cache at decode_32k, leaf by leaf against the reference's over
  ``jax.eval_shape``. A leaf the port keeps in a per-layer list is held to
  the reference's stacked leaf without its leading "layers" entry.
* ``zero1_state_specs`` the same way. Where the reference's stacked leaf
  takes a ZeRO axis on L, the port's per-layer leaf takes it where the
  reference's ``add_zero_axis`` puts it on the per-layer spec and shape;
  the leaves that then stay replicated over an axis the reference shards
  on L are counted, and the counts are the ones ROADMAP Queue 3 records.
* ``placements``/``spec_of`` round trips on a DeviceMesh-shaped object:
  ('pod', 'data') on one dimension is Shard(d) on both, in mesh order.
"""
import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import repro.optim.adamw as jadamw
import repro.parallel.sharding as jsh
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.models.registry import get_model as jax_get_model
from repro_torch.configs import (REFERENCE_ARCHS, SHAPES, get_config,
                                  input_specs)
from repro_torch.configs.base import OptimizerConfig
from repro_torch.models.registry import get_model, param_shapes
from repro_torch.optim import add_zero_axis, zero1_state_specs
from repro_torch.parallel.sharding import (DEFAULT_RULES, LAYERS_REFUSED, P,
                                           ShardingRules, drop_indivisible,
                                           logical_constraint, placements,
                                           spec_of, tree_specs_shaped)
from repro_torch.training import rules_for, shardings_for
from repro_torch.utils import tree_leaves

MESHES = [{"data": 1, "model": 1}, {"data": 4, "model": 2},
          {"data": 2, "model": 4}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}]
MESH_IDS = ["x".join(map(str, m.values())) for m in MESHES]
# leaves whose ZeRO axis the reference puts on the stacked L and that
# stay replicated over it in the port, no free dimension of the per-layer
# leaf dividing (all archs' full configs), by mesh: a deliberate
# difference (ROADMAP Queue 3). On every mesh rwkv6-7b's 32 layers' 'w0'
# and 'u', 1-D and already on 'model', take no 'data'; on (2, 16, 16) the
# leaves whose dimensions 'data' and 'model' fill take no 'pod' (gemma-7b
# 252, internlm2-1.8b 216, llava-next-34b 540, starcoder2-3b 300,
# whisper-medium 624).
ZERO_REPLICATED = {"1x1": 64, "4x2": 64, "2x4": 64, "16x16": 64,
                   "2x16x16": 1996}


class FakeMesh:
    """The reference's abstract mesh of tests/test_sharding_hlocost.py."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


# -- the rules: counterparts of tests/test_sharding_hlocost.py:21-62 --------------
def test_torch_rules_spec_basic():
    rules, mesh = ShardingRules(), {"data": 4, "model": 2}
    assert rules.spec(("batch", "seq", "embed"), mesh) == P("data")
    assert rules.spec(("vocab", "embed"), mesh) == P("model")
    assert rules.spec(("experts", "expert_cap", "embed"), mesh) == \
        P("model", "data")


def test_torch_rules_pod_axis_dropped_on_single_pod():
    rules = ShardingRules()
    assert rules.spec(("batch",), {"data": 16, "model": 16}) == P("data")
    assert rules.spec(("batch",), {"pod": 2, "data": 16, "model": 16}) == \
        P(("pod", "data"))


def test_torch_rules_no_double_assignment():
    rules = ShardingRules(overrides={"expert_in": "model"})
    spec = rules.spec(("experts", "expert_in", "ff"), {"data": 4,
                                                       "model": 2})
    used = [a for part in spec if part for a in
            (part if isinstance(part, tuple) else (part,))]
    assert len(used) == len(set(used))


def test_torch_drop_indivisible():
    mesh = {"data": 4, "model": 16}
    assert drop_indivisible(P("model", "data"), (56, 8), mesh) == \
        P(None, "data")
    assert drop_indivisible(P(("data", "model")), (32,), mesh) == P("data")


def test_torch_logical_constraint_noop_without_a_mesh():
    import torch
    x = torch.ones((4, 4))
    assert logical_constraint(x, "batch", "embed") is x


def test_torch_rules_table_and_the_refused_layers_rule():
    """The table is the reference's; a "layers" rule naming a mesh axis
    is refused with its reason (the port's layers are a list)."""
    assert DEFAULT_RULES == jsh.DEFAULT_RULES
    with pytest.raises(ValueError) as err:
        ShardingRules(overrides={"layers": "data"})
    assert str(err.value) == LAYERS_REFUSED
    ShardingRules(overrides={"layers": None})


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("axes", [
    ("batch", "seq", "embed"), ("batch", "act_seq", "embed"),
    ("experts", "expert_cap", "ff"), ("experts_a2a", "null", "ff"),
    ("embed_fsdp", "heads"), ("layers", "batch", "null", "kv_heads",
                              "head_dim"), ("lru",), ()])
def test_torch_rules_spec_equals_the_reference(mesh, axes):
    for over in ({}, {"expert_in": "data", "embed_fsdp": "data"},
                 {"act_seq": None, "batch": "data"}):
        got = ShardingRules(dict(over)).spec(axes, mesh)
        want = jsh.ShardingRules(dict(over)).spec(axes, FakeMesh(mesh))
        assert tuple(got) == tuple(want), (over, got, want)


# -- tree specs against the reference's ----------------------------------------------
def _port_leaves(tree, path=()):
    """(path, leaf) of a port spec tree; a list index enters the path as
    an int (a layer the reference stacks on L)."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _port_leaves(v, path
                                                                 + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _port_leaves(v, path + (i,))]
    return [(path, tree)]


def _ref_by_path(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {tuple(k.key for k in path): leaf for path, leaf in flat}


def _split(path):
    """(the reference's path, whether the leaf is one of a stacked list)."""
    return tuple(p for p in path if not isinstance(p, int)), \
        any(isinstance(p, int) for p in path)


def _jax_shapes(config):
    model = jax_get_model(config)
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), config))


def _check_tree(got, want):
    ref = _ref_by_path(want)
    leaves = _port_leaves(got)
    stacked = {p for p, _ in leaves if _split(p)[1]}
    assert {_split(p)[0] for p, _ in leaves} == set(ref)
    for path, spec in leaves:
        rpath, layer = _split(path)
        w = tuple(ref[rpath])
        if layer:
            assert not w or w[0] is None, (path, w)
            w = w[1:]
        assert tuple(spec) == w, (path, spec, w)
    return len(leaves), len(stacked)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", sorted(REFERENCE_ARCHS))
def test_torch_param_and_cache_specs_equal_the_reference(arch, mesh):
    config, jcfg = get_config(arch), jax_get_config(arch)
    assert config.sharding_overrides == jcfg.sharding_overrides
    assert config.pad_attention_heads == jcfg.pad_attention_heads
    rules, jrules = rules_for(config), jsh.ShardingRules(
        dict(jcfg.sharding_overrides))
    model, jmodel = get_model(config), jax_get_model(jcfg)
    fm = FakeMesh(mesh)
    got = tree_specs_shaped(model.param_specs(config), param_shapes(config),
                            mesh, rules)
    want = jsh.tree_specs_shaped(jmodel.param_specs(jcfg), _jax_shapes(jcfg),
                                 fm, jrules)
    n, _ = _check_tree(got, want)
    assert n == len(tree_leaves(param_shapes(config)))
    shape = SHAPES["decode_32k"]
    cache = input_specs(config, shape)["cache"]
    got = tree_specs_shaped(model.cache_specs(config), cache, mesh, rules)
    jshape = JSHAPES["decode_32k"]
    jcache = jax.eval_shape(lambda: jmodel.init_cache(
        jcfg, jshape.global_batch, jshape.seq_len))
    want = jsh.tree_specs_shaped(jmodel.cache_specs(jcfg), jcache, fm,
                                 jrules)
    # the cache's 'pos' is an int in the port, a () array in the reference
    _check_tree(got, want)


def _zero_counts(arch, mesh):
    """(ZeRO specs checked, leaves left replicated where the reference
    shards L) for one arch."""
    config, jcfg = get_config(arch), jax_get_config(arch)
    rules, jrules = rules_for(config), jsh.ShardingRules(
        dict(jcfg.sharding_overrides))
    fm = FakeMesh(mesh)
    shapes, jshapes = param_shapes(config), _jax_shapes(jcfg)
    pspecs = tree_specs_shaped(get_model(config).param_specs(config), shapes,
                               mesh, rules)
    jpspecs = jsh.tree_specs_shaped(jax_get_model(jcfg).param_specs(jcfg),
                                    jshapes, fm, jrules)
    got = zero1_state_specs(pspecs, shapes, mesh, OptimizerConfig())
    want = jadamw.zero1_state_specs(jpspecs, jshapes, fm, JOptimizerConfig())
    assert tuple(got["step"]) == tuple(want["step"]) == ()
    ref_z, ref_p = _ref_by_path(want["m"]), _ref_by_path(jpspecs)
    ref_shape = {tuple(k.key for k in p): leaf.shape for p, leaf in
                 jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    checked = replicated = 0
    for key in ("m", "v", "master"):
        assert {p for p, _ in _port_leaves(got[key])} == \
            {p for p, _ in _port_leaves(got["m"])}
    for path, spec in _port_leaves(got["m"]):
        rpath, layer = _split(path)
        wz = tuple(ref_z[rpath])
        if layer and wz and wz[0] is not None:
            # the reference put a ZeRO axis on L: the port adds it where
            # the reference's add_zero_axis adds it to the per-layer leaf
            per_layer = JP(*tuple(ref_p[rpath])[1:])
            shape = ref_shape[rpath][1:]
            want_leaf = jadamw.add_zero_axis(per_layer, shape, fm, "data")
            want_leaf = jadamw.add_zero_axis(want_leaf, shape, fm, "pod")
            assert tuple(spec) == tuple(want_leaf), (path, spec, want_leaf)
            on_l = set(wz[0] if isinstance(wz[0], tuple) else (wz[0],))
            used = {a for part in spec if part for a in
                    (part if isinstance(part, tuple) else (part,))}
            replicated += bool(on_l - used)
        else:
            assert tuple(spec) == (wz[1:] if layer else wz), (path, spec, wz)
        checked += 1
    return checked, replicated


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_torch_zero1_state_specs_equal_the_reference(mesh):
    """Per arch and mesh, ``zero1_state_specs`` as the reference's, but
    where L takes the axis there (module docstring); the leaves left
    replicated are the recorded ones."""
    replicated = 0
    for arch in sorted(REFERENCE_ARCHS):
        checked, n = _zero_counts(arch, mesh)
        assert checked > 0
        replicated += n
    assert replicated == ZERO_REPLICATED["x".join(map(str, mesh.values()))]


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_torch_add_zero_axis_equals_the_reference(mesh):
    fm = FakeMesh(mesh)
    for spec, shape in [((), (64,)), (("model",), (64, 16)),
                        ((None, "model"), (3, 16)), (("data",), (32, 8)),
                        ((("pod", "data"),), (64,)), ((), (7, 5)),
                        ((None, None, "model"), (4, 32, 16))]:
        for axis in ("data", "pod"):
            got = add_zero_axis(P(*spec), shape, mesh, axis)
            want = jadamw.add_zero_axis(JP(*spec), shape, fm, axis)
            assert tuple(got) == tuple(want), (spec, shape, axis)


def test_torch_zero1_off_keeps_the_parameter_specs():
    specs = {"w": P("model"), "b": P()}
    shapes = {"w": np.zeros((64, 8)), "b": np.zeros((8,))}
    got = zero1_state_specs(specs, shapes, {"data": 4, "model": 2},
                            OptimizerConfig(zero1=False))
    assert got["m"] == specs and got["master"] == specs


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
def test_torch_shardings_for_every_cell_of_internlm2(kind):
    """``shardings_for`` on the reference's cells equals the reference's
    (the batch's, the cache's and the parameters' specs)."""
    import repro.training as jtraining

    mesh = {"data": 16, "model": 16}
    config, jcfg = get_config("internlm2-1.8b"), jax_get_config(
        "internlm2-1.8b")
    got = shardings_for(config, SHAPES[kind], mesh)
    want = jtraining.shardings_for(jcfg, JSHAPES[kind], FakeMesh(mesh))
    _check_tree(got.param_specs, want.param_specs)
    _check_tree(got.batch_specs, want.batch_specs)
    if kind == "train_4k":
        _check_tree(got.state_specs["params"], want.state_specs["params"])
    else:
        _check_tree(got.cache_specs, want.cache_specs)


def test_torch_placements_round_trip():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:            # what ``placements`` reads of a DeviceMesh
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    spec = P(("pod", "data"), None, "model")
    got = placements(spec, Mesh())
    assert got == (Shard(0), Shard(0), Shard(2))
    assert tuple(spec_of(got, Mesh())) == tuple(spec)
    assert placements(P(), Mesh()) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        placements(P(("data", "pod")), Mesh())
