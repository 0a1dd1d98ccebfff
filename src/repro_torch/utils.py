"""Shared utilities of the port: logging, device resolution, a map over
nested dicts, lists and tuples of tensors and their leaves, and the
reference's ``tree_params``, ``tree_any_nan`` and ``human_count``
(``repro/utils.py``)."""
from __future__ import annotations

import logging
import os
from typing import Any, Callable

import torch

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
