"""Dispatch for the overlap products: the CUDA kernel for a CUDA tensor,
the plain PyTorch version for a CPU tensor. A kernel that fails to build or
launch raises; nothing falls back to the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.overlap import kernel, ref


def overlap_products(a: torch.Tensor, b: torch.Tensor,
                     use_kernel: bool | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """a: complex64 (F, H, W); b: (F, H, W) or (H, W) -> (a · conj(b),
    |b|²). ``use_kernel=None`` means the kernel iff ``a`` is on CUDA;
    ``False`` asks for the plain version on either device."""
    if a.is_cuda if use_kernel is None else use_kernel:
        return kernel.overlap_products(a, b)
    return ref.overlap_products_ref(a, b)
