"""Plain PyTorch version of the RAAR combine (the kernel's oracle), the same
function as ``repro/kernels/raar/ref.py:raar_combine_complex``."""
from __future__ import annotations

import torch


def raar_combine_ref(psi: torch.Tensor, p1: torch.Tensor, p21: torch.Tensor,
                     p2: torch.Tensor, beta: float = 0.75) -> torch.Tensor:
    """Eq. 7: ``2β·p21 + (1-2β)·p1 + β·(psi - p2)`` on complex64."""
    return 2 * beta * p21 + (1 - 2 * beta) * p1 + beta * (psi - p2)
