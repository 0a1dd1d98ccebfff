"""Launch wrapper of the CUDA overlap-products kernel (csrc/overlap.cu), the
counterpart of ``repro/kernels/overlap/kernel.py:overlap_products``."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def overlap_products(a: torch.Tensor, b: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """a: complex64 (F, H, W); b: complex64 (F, H, W), or (H, W) shared by
    every frame and read in place (never broadcast into a copy). Both
    contiguous on one CUDA device -> (a · conj(b) complex64, |b|² fp32),
    both (F, H, W)."""
    op = "overlap_products"
    _build.check_tensor(op, "a", a, torch.complex64, a.shape)
    if a.dim() != 3:
        raise ValueError(f"{op}: a must be (F, H, W), got {tuple(a.shape)}")
    b_shape = tuple(a.shape) if b.dim() == 3 else tuple(a.shape[1:])
    _build.check_tensor(op, "b", b, torch.complex64, b_shape, a.device)
    num = torch.empty_like(a)
    den = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    lib = _build.load_library()
    with torch.cuda.device(a.device):
        rc = lib.overlap_products_launch(
            a.data_ptr(), b.data_ptr(), num.data_ptr(), den.data_ptr(),
            a.numel(), b.numel(), _build.current_stream(a.device))
    _build.check_launch(op, rc)
    with _build.COUNT_LOCK:
        overlap_products.launches += 1
    return num, den


overlap_products.launches = 0
