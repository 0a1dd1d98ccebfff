"""Dispatch for the modulus projection: the CUDA kernel for a CUDA tensor,
the plain PyTorch version for a CPU tensor. A kernel that fails to build or
launch raises; nothing falls back to the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.modulus import kernel, ref


def modulus_project(far: torch.Tensor, mag: torch.Tensor,
                    use_kernel: bool | None = None) -> torch.Tensor:
    """far: complex64 (F, H, W); mag: fp32 (F, H, W) -> complex64.
    ``use_kernel=None`` means the kernel iff ``far`` is on CUDA; ``False``
    asks for the plain version on either device."""
    if far.is_cuda if use_kernel is None else use_kernel:
        return kernel.modulus_project(far, mag)
    return ref.modulus_project_ref(far, mag)
