"""The port's checkpoints on the CPU: the counterparts of
tests/test_checkpoint.py (round trip with bf16, the LATEST pointer, a crash
mid-save, the async checkpointer's gc, a missing leaf), and the on-disk
layout crossing the packages both ways: the reference saves and the port
restores, the port saves and the reference restores, fp32, bf16, complex64
and int32 leaves in nested dicts and lists, read back bit-equal."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step, restore,
                                    save)


def tree():
    return {"params": {"w": torch.arange(12, dtype=torch.bfloat16).reshape(
        3, 4), "b": torch.ones(5, dtype=torch.float32)},
        "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _leaves(v)]
    return [t]


def _bits(x) -> np.ndarray:
    """A leaf's bytes as an unsigned array: bit-equality, NaNs included."""
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
             else x.numpy())
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(f"u{a.dtype.itemsize}")


def test_torch_roundtrip_bf16(tmp_path):
    t = tree()
    save(str(tmp_path), 7, t)
    got, step = restore(str(tmp_path), t)
    assert step == 7
    for a, b in zip(_leaves(t), _leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_torch_latest_pointer_and_explicit_step(tmp_path):
    t = tree()
    save(str(tmp_path), 1, t)
    save(str(tmp_path), 5, t)
    assert latest_step(str(tmp_path)) == 5
    _, step = restore(str(tmp_path), t, step=1)
    assert step == 1
    assert latest_step(str(tmp_path / "nothing")) is None
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "nothing"), t)


def test_torch_crash_mid_save_keeps_previous(tmp_path):
    """A stale .tmp dir (crash artifact) must not break restore of the last
    good checkpoint."""
    t = tree()
    save(str(tmp_path), 3, t)
    os.makedirs(tmp_path / "step_00000004.tmp")
    with open(tmp_path / "step_00000004.tmp" / "garbage.npy", "w") as f:
        f.write("partial")
    _, step = restore(str(tmp_path), t)
    assert step == 3
    save(str(tmp_path), 4, t)              # the stale .tmp is replaced
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000003",
                                            "step_00000004"]


def test_torch_async_checkpointer_and_gc(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    t = tree()
    for s in (1, 2, 3, 4):
        ck.save(s, t)
        t["params"]["b"] += 1             # the snapshot was taken already
    ck.wait()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]
    got, step = restore(str(tmp_path), t)
    assert step == 4
    np.testing.assert_array_equal(got["params"]["b"].numpy(),
                                  np.full(5, 4.0, np.float32))


def test_torch_async_checkpointer_surfaces_write_errors(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker / "ckpt"))
    ck.save(1, tree())
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                              # reported once


def test_torch_missing_leaf_raises(tmp_path):
    t = tree()
    save(str(tmp_path), 1, t)
    bigger = {**t, "extra": torch.zeros(2)}
    with pytest.raises(KeyError):
        restore(str(tmp_path), bigger)


def _mixed_numpy():
    rng = np.random.default_rng(5)
    f32 = rng.standard_normal((4, 6)).astype(np.float32)
    f32[0, 0] = np.nan
    c64 = (rng.standard_normal((3, 8, 8))
           + 1j * rng.standard_normal((3, 8, 8))).astype(np.complex64)
    bf16 = np.asarray(jnp.asarray(rng.standard_normal((5, 7)),
                                  jnp.bfloat16))
    return {"state": {"psi": c64, "probe": c64[0], "obj": f32},
            "params": [bf16, bf16[:2]],
            "zeta": {"b": rng.standard_normal(3).astype(np.float32),
                     "a": np.asarray(11, np.int32)}}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    if tree.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(tree).view(np.uint16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(tree))


def test_torch_checkpoint_reference_saves_port_restores(tmp_path):
    host = _mixed_numpy()
    jckpt.save(str(tmp_path), 12, jax.tree_util.tree_map(jnp.asarray, host))
    like = _as_torch(host)
    got, step = restore(str(tmp_path), like)
    assert step == 12
    assert got["params"][0].dtype == torch.bfloat16
    assert got["state"]["psi"].dtype == torch.complex64
    for a, b in zip(_leaves(like), _leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_torch_checkpoint_port_saves_reference_restores(tmp_path):
    host = _mixed_numpy()
    path = save(str(tmp_path), 9, _as_torch(host))
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["leaves"]["params__0"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["state__psi"]["dtype"] == "complex64"
    assert sorted(os.listdir(path)) == sorted(
        [k + ".npy" for k in manifest["leaves"]] + ["manifest.json"])
    like = jax.eval_shape(lambda: jax.tree_util.tree_map(jnp.asarray, host))
    got, step = jckpt.restore(str(tmp_path), like)
    assert step == 9
    for a, b in zip(jax.tree_util.tree_leaves(host),
                    jax.tree_util.tree_leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(np.asarray(b)))


def test_torch_checkpoint_files_equal_the_reference(tmp_path):
    """Both packages write the same leaf files for the same state."""
    host = _mixed_numpy()
    jckpt.save(str(tmp_path / "ref"), 1,
               jax.tree_util.tree_map(jnp.asarray, host))
    save(str(tmp_path / "port"), 1, _as_torch(host))
    ref, port = tmp_path / "ref" / "step_00000001", \
        tmp_path / "port" / "step_00000001"
    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(port))
    for name in names:
        assert (ref / name).read_bytes() == (port / name).read_bytes(), name
    assert (tmp_path / "ref" / "LATEST").read_text() == \
        (tmp_path / "port" / "LATEST").read_text()


def test_torch_restore_onto_a_device(tmp_path):
    t = tree()
    save(str(tmp_path), 2, t)
    for device in ("cpu", torch.device("cpu")):
        got, _ = restore(str(tmp_path), t, device=device)
        assert all(x.device.type == "cpu" for x in _leaves(got))
        for a, b in zip(_leaves(t), _leaves(got)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
