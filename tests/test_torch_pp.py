"""The GPipe pipeline (``repro_torch.parallel.pp``) on 8 spawned gloo
ranks over a (pod 2, data 2, model 2) mesh, against the sequential stack
in JAX and in the port.

The ranks are spawned once for the module (``gloo8``) and run every case.

* tests/test_multidevice.py:248 in the port: L 4, B 8, S 16, D 32, 4
  microbatches over 2 stages of ``tanh(x @ w) + x`` blocks, on numpy W and
  x; the output within 2e-5 and the gradient of sum(y²) with respect to
  every W within 2e-4 of the JAX sequential stack on the same W and x
  (``jax.grad``). Each stage holds the gradients of its own layers; none
  is summed over the stages (the output is the same on every rank, and
  so is its gradient).
* internlm2-1.8b's ``reduced()`` blocks (``transformer._block``)
  pipelined in fp32, each stage's blocks under its (data 2, model 2)
  sub-mesh, against the port's ``_run_layers`` in one process: the output
  within 2e-5 and the gradients of sum(y²) within 2e-4 of each leaf's
  largest magnitude.
* The host-staged backend (the one a gloo mesh takes on the card): its
  ``send``, ``recv`` and ``broadcast`` under the toy pipeline on 2
  ranks, and its all-to-all of int32 blocks.
* The one-stage path, the layers in turn, and both asserts with the
  reference's messages (host only: they come before any collective).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer
from repro_torch.parallel.pp import pipeline_layers
from tests.test_torch_bridge import spawn_ranks

WORLD, MESH = 8, ((2, 2, 2), ("pod", "data", "model"))
L, B, S, D, MICRO = 4, 8, 16, 32, 4
FWD_TOL, GRAD_TOL = 2e-5, 2e-4             # tests/test_multidevice.py:268-276
ARCH = "internlm2-1.8b"


def _w_x():
    rng = np.random.default_rng(0)
    W = (rng.standard_normal((L, D, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return W, x


def _run_block(x, w):
    return torch.tanh(x @ w) + x


def _config():
    return get_config(ARCH, reduced=True).replace(
        dtype="float32", param_dtype="float32")


def _model_inputs(config):
    params = transformer.init(torch.Generator().manual_seed(0), config)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, config.vocab_size, (B, S)))
    with torch.no_grad():
        x, _ = transformer._embed_inputs(params, {"tokens": tokens}, config)
    return params, x


def _block_fn(config):
    positions = torch.arange(S).expand(B // MICRO, S)

    def run(x, p):
        return transformer._block(x, p, config, positions, None)[0]
    return run


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for sub in tree for v in _leaves(sub)]
    return [tree]


# -- the ranks ---------------------------------------------------------------------
def _pp_rank(rank, world, params, x_model):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel.sharding import (place_tree,
                                               tree_specs_shaped,
                                               use_mesh, whole)
    from repro_torch.training import rules_for

    mesh = init_device_mesh("cpu", MESH[0], mesh_dim_names=MESH[1])
    out = {"coord": mesh.get_coordinate()}
    W, x = _w_x()
    Wt = [torch.from_numpy(W[i]).requires_grad_() for i in range(L)]
    y = pipeline_layers(_run_block, Wt, torch.from_numpy(x), mesh, L,
                        microbatches=MICRO)
    grads = torch.autograd.grad((y ** 2).sum(), Wt, allow_unused=True)
    out["toy"] = (y.detach().numpy(), [None if g is None else g.numpy()
                                       for g in grads])

    # the blocks place their activations on each stage's sub-mesh: the
    # forward and backward passes under the mesh, as a sharded step's
    # each rank's layers placed on its stage's sub-mesh by the block's specs
    config = _config()
    sub = mesh["data", "model"]
    rules = rules_for(config)
    spec = transformer._block_specs(config)
    live = [place_tree(p, tree_specs_shaped(spec, p, sub, rules), sub)
            for p in params["layers"]]
    live = [{k: {n: t.detach().requires_grad_() for n, t in v.items()}
             for k, v in p.items()} for p in live]
    with use_mesh(mesh, rules):
        y = pipeline_layers(_block_fn(config), live, x_model, mesh,
                            config.num_layers, microbatches=MICRO)
        leaves = _leaves(live)
        grads = torch.autograd.grad((y ** 2).sum(), leaves,
                                    allow_unused=True)
    # a parameter's gradient comes back a DTensor of its stage's sub-mesh
    out["model"] = (y.detach().numpy(), [
        None if g is None else whole(g).numpy() for g in grads])
    return out


@pytest.fixture(scope="module")
def gloo8(tmp_path_factory):
    params, x = _model_inputs(_config())
    return spawn_ranks(_pp_rank, WORLD, (params, x),
                       tmp_path_factory.mktemp("pp8"), timeout=600)


def _stage_of(layer, n_layers, n_stages=MESH[0][0]):
    return layer // (n_layers // n_stages)


# -- against JAX ---------------------------------------------------------------------
def test_torch_gpipe_matches_the_jax_sequential_stack(gloo8):
    """Forward and the gradient of sum(y²) on every rank against JAX's
    sequential stack of the same blocks on the same numpy W and x."""
    W, x = _w_x()

    def seq(x, W):
        for i in range(L):
            x = jnp.tanh(x @ W[i]) + x
        return x

    want = np.asarray(jax.jit(seq)(x, W))
    g_want = np.asarray(jax.grad(lambda W: jnp.sum(seq(x, W) ** 2))(W))
    for out in gloo8:
        y, grads = out["toy"]
        np.testing.assert_allclose(y, want, rtol=FWD_TOL, atol=FWD_TOL)
        stage = out["coord"][0]
        for i, g in enumerate(grads):
            if _stage_of(i, L) == stage:
                np.testing.assert_allclose(g, g_want[i], rtol=GRAD_TOL,
                                           atol=GRAD_TOL, err_msg=str(i))
            else:
                assert g is None, i


def test_torch_gpipe_stages_hold_their_own_layers_only(gloo8):
    """The ranks of one stage agree, whatever their data and model
    coordinates, and every layer's gradient lives on exactly one stage."""
    by_stage = {}
    for out in gloo8:
        by_stage.setdefault(out["coord"][0], []).append(out["toy"][1])
    for stage, runs in by_stage.items():
        for grads in runs[1:]:
            for a, b in zip(grads, runs[0]):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
    held = [i for i in range(L) for s in by_stage
            if by_stage[s][0][i] is not None]
    assert sorted(held) == list(range(L))


# -- the model's blocks ---------------------------------------------------------------
def test_torch_pipelined_blocks_match_run_layers(gloo8):
    """internlm2-1.8b's reduced() blocks over 2 stages, each stage's on
    its (data 2, model 2) sub-mesh, against ``_run_layers`` in one
    process: forward within 2e-5, gradients within 2e-4 of each leaf's
    largest magnitude."""
    config = _config()
    params, x = _model_inputs(config)
    live = [{k: {n: t.clone().requires_grad_() for n, t in v.items()}
             for k, v in p.items()} for p in params["layers"]]
    positions = torch.arange(S).expand(B, S)
    y, _, _ = transformer._run_layers(x, {"layers": live}, config, positions,
                                      None)
    leaves = _leaves(live)
    g_want = torch.autograd.grad((y ** 2).sum(), leaves)
    want = y.detach().numpy()
    per = len(leaves) // config.num_layers
    for out in gloo8:
        got, grads = out["model"]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=FWD_TOL * np.abs(want).max())
        stage = out["coord"][0]
        for i, (g, w) in enumerate(zip(grads, g_want)):
            if _stage_of(i // per, config.num_layers) != stage:
                assert g is None, i
                continue
            w = w.numpy()
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=GRAD_TOL * np.abs(w).max(),
                                       err_msg=str(i))


# -- the host-staged backend ------------------------------------------------------------
class _Axis:
    """What ``gpipe_apply`` reads of a mesh: the axis's group and this
    rank's coordinate on it."""

    def __init__(self, group, rank):
        self.group, self.rank = group, rank

    def get_group(self, axis):
        return self.group

    def get_local_rank(self, axis):
        return self.rank


def _staged_rank(rank, world):
    """The toy pipeline's hops, broadcast and backward hops, and an int32
    all-to-all, on a group of the host-staged backend (the one a gloo
    mesh takes on the card) over CPU tensors."""
    import torch.distributed as dist

    from repro_torch.models.moe import _all_to_all
    from repro_torch.parallel.pp import gpipe_apply
    from repro_torch.parallel.sharding import (host_staged_class,
                                               register_host_staged)

    group = dist.new_group(backend=register_host_staged())
    W, x = _w_x()
    Wt = [torch.from_numpy(W[i]).requires_grad_() for i in range(L)]
    per = L // world

    def stage(h, params):
        for w in params:
            h = _run_block(h, w)
        return h

    mbs = torch.from_numpy(x).reshape(MICRO, B // MICRO, S, D)
    y = gpipe_apply(stage, Wt[rank * per:(rank + 1) * per], mbs, world,
                    mesh=_Axis(group, rank)).reshape(B, S, D)
    grads = torch.autograd.grad((y ** 2).sum(), Wt, allow_unused=True)
    ids = (torch.arange(4, dtype=torch.int32) + 10 * rank).view(world, -1)
    return {"y": y.detach().numpy(),
            "grads": [None if g is None else g.numpy() for g in grads],
            "a2a": _all_to_all(ids, group, list(range(world))).tolist(),
            "staged_s": host_staged_class().seconds}


@pytest.fixture(scope="module")
def staged2(tmp_path_factory):
    return spawn_ranks(_staged_rank, 2, (), tmp_path_factory.mktemp("hs2"),
                       timeout=300)


def test_torch_host_staged_backend_runs_the_pipeline(staged2):
    """The host-staged backend's send, recv and broadcast carry the 2-stage
    toy pipeline to JAX's sequential stack (2e-5, gradients 2e-4), and its
    all-to-all moves int32 blocks: rank r gets block r of each rank's."""
    W, x = _w_x()

    def seq(x, W):
        for i in range(L):
            x = jnp.tanh(x @ W[i]) + x
        return x

    want = np.asarray(seq(x, W))
    g_want = np.asarray(jax.grad(lambda W: jnp.sum(seq(x, W) ** 2))(W))
    for r, out in enumerate(staged2):
        np.testing.assert_allclose(out["y"], want, rtol=FWD_TOL,
                                   atol=FWD_TOL)
        for i, g in enumerate(out["grads"]):
            if _stage_of(i, L) == r:
                np.testing.assert_allclose(g, g_want[i], rtol=GRAD_TOL,
                                           atol=GRAD_TOL)
            else:
                assert g is None
        assert out["a2a"] == [[2 * r, 2 * r + 1], [10 + 2 * r, 11 + 2 * r]]
        assert out["staged_s"] > 0


# -- host only ---------------------------------------------------------------------
def test_torch_one_stage_runs_the_layers_in_turn():
    """Without a second stage (no 'pod' axis, or one of size 1), the
    layers in turn: exactly the sequential stack."""
    W, x = _w_x()
    want = torch.from_numpy(x)
    for w in W:
        want = _run_block(want, torch.from_numpy(w))
    for mesh in ({"data": 2, "model": 4}, {"pod": 1, "data": 8}):
        got = pipeline_layers(_run_block, [torch.from_numpy(w) for w in W],
                              torch.from_numpy(x), mesh, L, MICRO)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("layers, micro, message", [
    (3, MICRO, "layers must split evenly into stages"),
    (L, 3, "batch must split into microbatches")])
def test_torch_pipeline_asserts(layers, micro, message):
    W, x = _w_x()
    with pytest.raises(AssertionError, match=message):
        pipeline_layers(_run_block, [torch.from_numpy(w) for w in W],
                        torch.from_numpy(x), {"pod": 2, "data": 1}, layers,
                        micro)
