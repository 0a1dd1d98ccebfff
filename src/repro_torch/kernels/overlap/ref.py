"""Plain PyTorch version of the overlap products (the kernel's oracle).

The same function as ``repro/kernels/overlap/ref.py:overlap_products_ref``,
on complex64: the products are taken on the real and imaginary planes in
the order the kernels use."""
from __future__ import annotations

import torch


def overlap_products_ref(a: torch.Tensor, b: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """a: complex64 (F, H, W); b: complex64 (F, H, W) or (H, W), broadcast
    over F -> (a · conj(b) complex64, |b|² fp32), both (F, H, W)."""
    a_re, a_im, b_re, b_im = a.real, a.imag, b.real, b.imag
    n_re = a_re * b_re + a_im * b_im
    n_im = a_im * b_re - a_re * b_im
    den = (b_re * b_re + b_im * b_im).expand(a.shape)
    return torch.complex(n_re, n_im), den.contiguous()
