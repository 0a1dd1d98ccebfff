"""Dispatch for the RAAR combine: the CUDA kernel for a CUDA tensor, the
plain PyTorch version for a CPU tensor. A kernel that fails to build or
launch raises; nothing falls back to the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.raar import kernel, ref


def raar_combine(psi: torch.Tensor, p1: torch.Tensor, p21: torch.Tensor,
                 p2: torch.Tensor, beta: float = 0.75,
                 use_kernel: bool | None = None) -> torch.Tensor:
    """Eq. 7. ``use_kernel=None`` means the kernel iff ``psi`` is on CUDA;
    ``False`` asks for the plain version on either device."""
    if psi.is_cuda if use_kernel is None else use_kernel:
        return kernel.raar_combine(psi, p1, p21, p2, beta)
    return ref.raar_combine_ref(psi, p1, p21, p2, beta)
