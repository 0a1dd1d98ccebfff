"""The bridge a pipeline hands to each batch's collective program.

The counterpart of ``repro/core/bridge.py:MPIBridge``, trimmed to what the
§III streaming path needs: the device the program runs on, the world size,
and the ``torch.distributed`` process group its partial sums are
all-reduced over (``None`` for one process, where the all-reduce is a
no-op). It never starts JAX.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class TorchBridge:
    device: torch.device
    world: int = 1
    group: Any = None
