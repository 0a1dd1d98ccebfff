"""Plain PyTorch version of the modulus projection (the kernel's oracle).

The same function as ``repro/kernels/modulus/ref.py:modulus_project_ref``,
in its ``rsqrt(re² + im² + EPS)`` form, on complex64 in and out."""
from __future__ import annotations

import torch

EPS = 1e-12


def modulus_project_ref(far: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    """far: complex64 (F, H, W); mag: fp32 (F, H, W) -> complex64."""
    re, im = far.real, far.imag
    scale = mag * torch.rsqrt(re * re + im * im + EPS)
    return torch.complex(re * scale, im * scale)
