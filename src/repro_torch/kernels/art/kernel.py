"""Launch wrapper of the CUDA ART-sweep kernel (csrc/art.cu), the counterpart
of ``repro/kernels/art/kernel.py:art_sweep`` batched over slices."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def art_sweep(A: torch.Tensor, b: torch.Tensor, inv_rip: torch.Tensor,
              f0: torch.Tensor, beta: float = 1.0,
              iters: int = 1) -> torch.Tensor:
    """A: fp32 (nrow, ncol), shared by every slice; b: fp32 (S, nrow);
    inv_rip: fp32 (nrow,) = 1/‖A_j‖²; f0: fp32 (S, ncol) initial images; all
    contiguous on one CUDA device. Returns f (S, ncol) after ``iters`` full
    sweeps; the kernel updates a copy of ``f0`` in place. ``beta`` and
    ``iters`` are runtime arguments."""
    op = "art_sweep"
    _build.check_tensor(op, "A", A, torch.float32, A.shape)
    if A.dim() != 2:
        raise ValueError(f"{op}: A must be (nrow, ncol), got {tuple(A.shape)}")
    if b.dim() != 2:
        raise ValueError(f"{op}: b must be (S, nrow), got {tuple(b.shape)}")
    nrow, ncol = A.shape
    nslice = b.shape[0]
    _build.check_tensor(op, "b", b, torch.float32, (nslice, nrow), A.device)
    _build.check_tensor(op, "inv_rip", inv_rip, torch.float32, (nrow,),
                        A.device)
    _build.check_tensor(op, "f0", f0, torch.float32, (nslice, ncol),
                        A.device)
    if iters < 0:
        raise ValueError(f"{op}: iters must be >= 0, got {iters}")
    f = torch.empty_like(f0)
    f.copy_(f0)
    lib = _build.load_library()
    with torch.cuda.device(A.device):
        rc = lib.art_sweep_launch(
            A.data_ptr(), b.data_ptr(), inv_rip.data_ptr(), f.data_ptr(),
            nrow, ncol, nslice, int(iters), float(beta),
            _build.current_stream(A.device))
    _build.check_launch(op, rc)
    art_sweep.launches += 1
    return f


art_sweep.launches = 0
