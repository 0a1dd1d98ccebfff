"""Shared utilities of the port: logging, device resolution, a map over
nested dicts, lists and tuples of tensors and their leaves, the
reference's timing, tree and numeric helpers (``repro/utils.py``), and
``cost_scope``, the span log's cost scope (``data/metrics.py``) that
``launch/opcost.py`` reads, under the name the models import."""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import Any, Callable, Iterator

import torch

from repro_torch.data.metrics import cost_scope  # noqa: F401

_LOG_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str) -> logging.Logger:
    if not name.startswith("repro_torch"):   # e.g. "__main__" under -m
        name = f"repro_torch.{name}"
    logger = logging.getLogger(name)
    root = logging.getLogger("repro_torch")
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_LOG_FORMAT))
        root.addHandler(handler)
        root.setLevel(os.environ.get("REPRO_LOG_LEVEL", "INFO"))
    return logger


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device to run on. Asking for CUDA on a host without a
    usable GPU raises: the port never drops to the CPU on its own, so a
    number measured on the CPU can never pass for a device number."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples, with the
    matching leaves of ``rest`` (trees of the same structure) as further
    arguments; the structure is kept. Anything else is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of nested dicts, lists and tuples, in ``tree_map``'s
    order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_params(tree: Any) -> int:
    """Total element count of the tensor leaves."""
    return sum(leaf.numel() for leaf in tree_leaves(tree)
               if isinstance(leaf, torch.Tensor))


def tree_any_nan(tree: Any) -> bool:
    """Whether a floating-point leaf holds a NaN."""
    return any(bool(torch.isnan(leaf).any()) for leaf in tree_leaves(tree)
               if isinstance(leaf, torch.Tensor)
               and leaf.is_floating_point())


def human_count(n: float) -> str:
    for unit in ("", "K", "M", "B", "T"):
        if abs(n) < 1000.0:
            return f"{n:.2f}{unit}"
        n /= 1000.0
    return f"{n:.2f}Q"


def peak_memory_bytes(memory: dict) -> int:
    """The peak of a dry-run's memory record (``launch/dryrun.py``), read
    as the reference reads ``memory_analysis()``: 'peak_bytes' where the
    record has one, else argument + output + temp bytes, less any alias
    bytes."""
    if memory.get("peak_bytes") is not None:
        return int(memory["peak_bytes"])
    return int(memory["argument_bytes"] + memory["output_bytes"]
               + memory["temp_bytes"] - memory.get("alias_bytes", 0))


@contextlib.contextmanager
def timed(label: str, sink: dict | None = None) -> Iterator[None]:
    """Context manager measuring wall time; optionally records into
    ``sink``."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[label] = dt


def block_tree(tree: Any) -> Any:
    """Wait for the devices of a tree's CUDA tensors (for honest timing);
    CPU tensors need no wait."""
    devices = {leaf.device for leaf in tree_leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


def tree_bytes(tree: Any) -> int:
    """Total byte size of the tensor leaves (meta tensors included)."""
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(tree)
               if isinstance(leaf, torch.Tensor))


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} PiB"


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


def asdict_shallow(obj: Any) -> dict:
    """``dataclasses.asdict`` without deep-copying tensor fields."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
