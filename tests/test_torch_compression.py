"""The port's int8 gradient compression on the CPU, held to the JAX
package's on the same numpy inputs: the codes and scales of
``quantize_int8`` (equal), the int8 sum over ranks against the reference's
``compressed_psum`` under ``vmap`` with an axis name (equal), and
``ef_compress_tree`` over several steps (the counterparts of
tests/test_optim.py's int8 and error-feedback tests, step for step against
the reference's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jc
from repro_torch.optim.compression import (compressed_psum, compressed_sum,
                                           dequantize_int8, ef_compress_tree,
                                           init_residual, quantize_int8)

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    HAVE_HYPOTHESIS = False


def _inputs(kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "normal":
        return rng.standard_normal(4096).astype(np.float32)
    if kind == "wide":
        return rng.uniform(-1e3, 1e3, (64, 33)).astype(np.float32)
    if kind == "tiny":
        return rng.uniform(-1e-3, 1e-3, 17).astype(np.float32)
    if kind == "zeros":
        return np.zeros(8, np.float32)
    if kind == "ties":       # x / scale lands on k + 0.5: round half to even
        return (np.arange(-8, 9, dtype=np.float32) + 0.5) / 8.5 * 127.0
    raise ValueError(kind)


KINDS = ("normal", "wide", "tiny", "zeros", "ties")


@pytest.mark.parametrize("kind", KINDS)
def test_torch_quantize_int8_matches_jax(kind):
    x = _inputs(kind)
    q, scale = quantize_int8(torch.from_numpy(x))
    jq, jscale = jc.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(dequantize_int8(q, scale).numpy(),
                                  np.asarray(jc.dequantize_int8(jq, jscale)))


def _check_int8_quantization_error_bound(xs):
    """|x - deq(quant(x))| <= scale/2 elementwise (symmetric rounding)."""
    x = torch.tensor(xs, dtype=torch.float32)
    q, scale = quantize_int8(x)
    err = (dequantize_int8(q, scale) - x).abs()
    assert bool(torch.all(err <= float(scale) * 0.5 + 1e-7))


def test_torch_int8_quantization_error_bound_smoke():
    rng = np.random.default_rng(11)
    for xs in ([0.0], [1e3, -1e3], rng.uniform(-1e3, 1e3, 64).tolist(),
               rng.uniform(-1e-3, 1e-3, 17).tolist()):
        _check_int8_quantization_error_bound(xs)


if HAVE_HYPOTHESIS:
    @given(st.lists(st.floats(-1e3, 1e3, allow_nan=False, width=32),
                    min_size=1, max_size=64))
    @settings(max_examples=40, deadline=None)
    def test_torch_property_int8_quantization_error_bound(xs):
        _check_int8_quantization_error_bound(xs)


@pytest.mark.parametrize("ranks", [1, 3, 8])
def test_torch_compressed_sum_matches_jax_compressed_psum(ranks):
    """The int8 sum of the ranks' blocks in one process is the reference's
    ``compressed_psum`` over a named axis of the same blocks, code for
    code; one block with no group is ``compressed_psum`` itself."""
    rng = np.random.default_rng(ranks)
    parts = rng.standard_normal((ranks, 1000)).astype(np.float32)
    parts[0, 3] = 9.0                  # one rank holds the largest value
    want = jax.vmap(lambda x: jc.compressed_psum(x, "w"),
                    axis_name="w")(jnp.asarray(parts))
    got = compressed_sum([torch.from_numpy(p) for p in parts])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])
    if ranks == 1:
        np.testing.assert_array_equal(
            compressed_psum(torch.from_numpy(parts[0])).numpy(),
            np.asarray(want)[0])
    exact = parts.sum(0)
    rel = np.linalg.norm(got.numpy() - exact) / np.linalg.norm(exact)
    assert rel < 0.05, rel


def test_torch_compressed_sum_keeps_dtype():
    x = torch.linspace(-1, 1, 64, dtype=torch.bfloat16)
    got = compressed_sum([x, x])
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), 2 * x.float(), rtol=0.02,
                               atol=2 / 127)


def test_torch_ef_compress_tree_matches_jax_over_steps():
    """Five steps of error feedback on a nested tree: the codes, scales,
    residuals and dequantized views equal the reference's at every step."""
    rng = np.random.default_rng(3)
    shapes = {"w": (8, 4), "layers": [(5,), (2, 3)], "b": (3,)}

    def grads():
        return {"w": rng.standard_normal(shapes["w"]).astype(np.float32),
                "layers": [rng.standard_normal(s).astype(np.float32) * 0.1
                           for s in shapes["layers"]],
                "b": rng.standard_normal(shapes["b"]).astype(np.float32)}

    def to_torch(tree):
        if isinstance(tree, dict):
            return {k: to_torch(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_torch(v) for v in tree]
        return torch.from_numpy(tree)

    params = to_torch(grads())
    res = init_residual(params)
    jres = jc.init_residual(jax.tree_util.tree_map(jnp.asarray, grads()))
    assert res["layers"][1].shape == (2, 3)
    for _ in range(5):
        g = grads()
        qtree, res, deq = ef_compress_tree(to_torch(g), res)
        jq, jres, jdeq = jc.ef_compress_tree(
            jax.tree_util.tree_map(jnp.asarray, g), jres)
        for ours, theirs in ((res, jres), (deq, jdeq)):
            for a, b in zip(jax.tree_util.tree_leaves(ours),
                            jax.tree_util.tree_leaves(theirs)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        q_leaves = [qtree["b"], qtree["layers"][0], qtree["layers"][1],
                    qtree["w"]]
        jq_leaves = [jq["b"], jq["layers"][0], jq["layers"][1], jq["w"]]
        for (q, s), (jqq, js) in zip(q_leaves, jq_leaves):
            np.testing.assert_array_equal(q.numpy(), np.asarray(jqq))
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_torch_error_feedback_compensates_bias():
    """With error feedback, the accumulated applied updates converge to the
    accumulated true gradients (bounded residual): the EF-SGD guarantee."""
    rng = np.random.default_rng(1)
    grads_seq = [rng.standard_normal((32,)).astype(np.float32) * 0.1
                 for _ in range(50)]
    residual = init_residual({"w": torch.zeros(32)})
    applied = np.zeros((32,), np.float32)
    for g in grads_seq:
        _, residual, deq = ef_compress_tree({"w": torch.from_numpy(g)},
                                            residual)
        applied += deq["w"].numpy()
    true_sum = np.sum(grads_seq, axis=0)
    gap = np.abs(applied - true_sum)
    res = np.abs(residual["w"].numpy())
    np.testing.assert_allclose(gap, res, rtol=1e-4, atol=1e-5)
    assert np.max(gap) < 0.05 * np.max(np.abs(true_sum)) + 0.05
