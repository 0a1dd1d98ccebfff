"""Plain PyTorch version of the ART sweep (the kernel's oracle), the same
function as ``repro/kernels/art/ref.py:art_sweep_ref`` with a batch axis of
slices in place of the reference solver's ``jax.vmap``."""
from __future__ import annotations

import torch


def art_sweep_ref(A: torch.Tensor, b: torch.Tensor, inv_rip: torch.Tensor,
                  f0: torch.Tensor, beta: float = 1.0,
                  iters: int = 1) -> torch.Tensor:
    """A (nrow, ncol); b (S, nrow); inv_rip (nrow,); f0 (S, ncol) -> f
    (S, ncol) after ``iters`` sweeps over the rows in order."""
    f = f0
    for _ in range(iters):
        for j in range(A.shape[0]):
            resid = (b[:, j] - f @ A[j]) * inv_rip[j]
            f = f + beta * resid[:, None] * A[j]
    return f
