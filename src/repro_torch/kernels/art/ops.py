"""Dispatch for the ART sweep (row-norm precompute, then the CUDA kernel for
a CUDA tensor, the plain PyTorch version for a CPU tensor). A kernel that
fails to build or launch raises; nothing falls back to the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.art import kernel, ref


def inverse_row_norms(A: torch.Tensor) -> torch.Tensor:
    """``1/‖A_j‖²``, 0 for an empty row, as ``repro/kernels/art/ops.py:19-20``
    computes it."""
    rip = (A * A).sum(dim=1)
    return torch.where(rip > 0, 1.0 / torch.clamp(rip, min=1e-12),
                       torch.zeros_like(rip))


def art_reconstruct(A: torch.Tensor, b: torch.Tensor, f0: torch.Tensor,
                    beta: float = 1.0, iters: int = 1,
                    use_kernel: bool | None = None,
                    inv_rip: torch.Tensor | None = None) -> torch.Tensor:
    """A batch of tilt-series slices: A (nrow, ncol), b (S, nrow), f0
    (S, ncol) -> (S, ncol). ``inv_rip`` is computed from ``A`` unless the
    caller passes it (the solver caches it with ``A``). ``use_kernel=None``
    means the kernel iff ``A`` is on CUDA; ``False`` asks for the plain
    version on either device."""
    if inv_rip is None:
        inv_rip = inverse_row_norms(A)
    if A.is_cuda if use_kernel is None else use_kernel:
        return kernel.art_sweep(A, b, inv_rip, f0, beta, iters)
    return ref.art_sweep_ref(A, b, inv_rip, f0, beta, iters)
