"""Atomic, async, elastic checkpointing of nested dicts, lists and tuples of
tensors: the counterpart of ``repro/checkpoint/ckpt.py``, on the same
on-disk layout, so each package restores what the other saved.

Layout:  <dir>/step_<N>/
            manifest.json      - step, and each leaf's dtype and shape
            <key>.npy          - one array a leaf, keys of the path
                                 joined by ``__`` (dict keys sorted)
         <dir>/LATEST          - atomic pointer (written last)

* atomicity: writes go to ``step_N.tmp``, renamed only after the manifest
  is fsynced, so a crash mid-save never corrupts the last good checkpoint;
* async: :class:`AsyncCheckpointer` copies the state to host memory
  synchronously and writes on a background thread;
* elastic restore: :func:`restore` puts each leaf on ``device``, so a job
  restarts on whatever worker set it has now;
* bf16: a bfloat16 leaf is stored as uint16 with ``"bfloat16"`` recorded
  in the manifest (npy has no bf16); complex64 is stored natively.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.utils import get_logger, tree_map

log = get_logger(__name__)

_SEP = "__"


def _flatten(tree: Any, prefix: tuple[str, ...] = ()) -> dict[str, Any]:
    """Leaves by key, in the order JAX flattens them: dict keys sorted,
    sequence items by index."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {_SEP.join(prefix): tree}
    out: dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, prefix + (k,)))
    return out


def _unflatten(like: Any, leaves: dict[str, Any],
               prefix: tuple[str, ...] = ()) -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(like))
    return leaves[_SEP.join(prefix)]


def _to_numpy(leaf: Any) -> tuple[np.ndarray, str]:
    """A leaf as the array written to disk, and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(directory: str, step: int, tree: Any) -> str:
    """Synchronous save. Returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest: dict[str, Any] = {"step": step, "leaves": {}}
    for key, leaf in _flatten(tree).items():
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, key + ".npy"), arr)
        manifest["leaves"][key] = {"dtype": dtype, "shape": list(arr.shape)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    latest_tmp = os.path.join(directory, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
        # without this the rename can publish an empty or torn pointer after
        # power loss, orphaning an otherwise complete checkpoint
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(directory, "LATEST"))
    _fsync_dir(directory)
    log.info("checkpoint saved: %s", final)
    return final


def _fsync_dir(directory: str) -> None:
    """Persist the renames themselves: step_N and LATEST are directory
    entries, and surviving power loss needs the directory flushed too."""
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse directory fsync; file fsyncs hold
    finally:
        os.close(fd)


def latest_step(directory: str) -> int | None:
    pointer = os.path.join(directory, "LATEST")
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        name = f.read().strip()
    return int(name.split("_")[-1])


def restore(directory: str, like: Any, step: int | None = None,
            device: str | torch.device | None = None) -> tuple[Any, int]:
    """Restore into the structure of ``like`` (only its structure is read).
    Every leaf goes to ``device`` (the CPU without one): the elastic
    restart onto the current worker set."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    restored: dict[str, torch.Tensor] = {}
    for key in _flatten(like):
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint {path} missing leaf {key}")
        arr = np.load(os.path.join(path, key + ".npy"))
        if meta["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        restored[key] = t if device is None else t.to(device)
    return _unflatten(like, restored), step


class AsyncCheckpointer:
    """Copy the state to host memory synchronously, write it on a
    background thread, and keep the newest ``keep`` checkpoints."""

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        host_tree = tree_map(
            lambda x: (x.detach().to("cpu", copy=True)
                       if isinstance(x, torch.Tensor) else np.array(x)),
            tree)

        def _write():
            try:
                save(self.directory, step, host_tree)
                self._gc()
            except Exception as exc:  # surfaced on the next wait()
                self._error = exc

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        steps = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for old in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, old),
                          ignore_errors=True)
