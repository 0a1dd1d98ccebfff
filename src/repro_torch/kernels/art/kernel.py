"""Launch wrapper of the CUDA ART-sweep kernel (csrc/art.cu), the counterpart
of ``repro/kernels/art/kernel.py:art_sweep`` batched over slices. The kernel
reads the system matrix as CSR (``ops.csr_rows`` builds it from the dense
A): only the non-zeros, which are all that change f."""
from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from repro_torch.kernels import _build


class CSR(NamedTuple):
    """A dense (nrow, ncol) fp32 matrix's non-zeros, row by row, columns
    ascending within a row."""
    row_ptr: torch.Tensor      # (nrow + 1,) int64
    col: torch.Tensor          # (nnz,) int32, each < ncol
    val: torch.Tensor          # (nnz,) fp32
    shape: tuple[int, int]     # (nrow, ncol)


def art_sweep(csr: CSR, b: torch.Tensor, inv_rip: torch.Tensor,
              f0: torch.Tensor, beta: float = 1.0,
              iters: int = 1) -> torch.Tensor:
    """csr: the system A (nrow, ncol) as ``ops.csr_rows`` builds it, shared
    by every slice; b: fp32 (S, nrow); inv_rip: fp32 (nrow,) = 1/‖A_j‖²;
    f0: fp32 (S, ncol) initial images; all contiguous on one CUDA device.
    Returns f (S, ncol) after ``iters`` full sweeps; the kernel updates a
    copy of ``f0`` in place. ``beta`` and ``iters`` are runtime
    arguments."""
    op = "art_sweep"
    if not isinstance(csr, CSR):
        raise TypeError(f"{op}: the system must be a CSR from csr_rows, got "
                        f"{type(csr)}")
    nrow, ncol = csr.shape
    _build.check_tensor(op, "row_ptr", csr.row_ptr, torch.int64, (nrow + 1,))
    dev = csr.row_ptr.device
    if csr.col.dim() != 1:
        raise ValueError(f"{op}: col must be 1-D, got {tuple(csr.col.shape)}")
    nnz = csr.col.shape[0]
    _build.check_tensor(op, "col", csr.col, torch.int32, (nnz,), dev)
    _build.check_tensor(op, "val", csr.val, torch.float32, (nnz,), dev)
    if b.dim() != 2:
        raise ValueError(f"{op}: b must be (S, nrow), got {tuple(b.shape)}")
    nslice = b.shape[0]
    _build.check_tensor(op, "b", b, torch.float32, (nslice, nrow), dev)
    _build.check_tensor(op, "inv_rip", inv_rip, torch.float32, (nrow,), dev)
    _build.check_tensor(op, "f0", f0, torch.float32, (nslice, ncol), dev)
    if iters < 0:
        raise ValueError(f"{op}: iters must be >= 0, got {iters}")
    f = torch.empty_like(f0)
    f.copy_(f0)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.art_sweep_csr_launch(
            csr.row_ptr.data_ptr(), csr.col.data_ptr(), csr.val.data_ptr(),
            b.data_ptr(), inv_rip.data_ptr(), f.data_ptr(), nrow, ncol,
            nslice, int(iters), float(beta), _build.current_stream(dev))
    _build.check_launch(op, rc)
    with _count_lock:          # consumers of a group launch from threads
        art_sweep.launches += 1
    return f


_count_lock = threading.Lock()
art_sweep.launches = 0
