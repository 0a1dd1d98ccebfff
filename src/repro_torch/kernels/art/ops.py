"""Dispatch for the ART sweep (row-norm precompute, then the CUDA kernel over
the system's non-zeros for a CUDA tensor, the plain dense PyTorch version
for a CPU tensor). A kernel that fails to build or launch raises; nothing
falls back to the plain version.

Each sweep is the span ``art``, on CUDA a device span. The §IV partitions
call it from several executor threads, each on a CUDA stream of its own
(``apps/tomo/stream.py:reconstruct_partition``), so their sweeps run side
by side on the card. A CUDA sweep enqueues its work under ``_ENQUEUE``, a
few µs: its host interval then holds its own launches and no other
thread's, and its span's ``in_flight`` counts the other threads' sweeps
enqueued and not yet finished on the card when it was enqueued (their end
events queried, never waited on)."""
from __future__ import annotations

import threading
from typing import Any

import torch

from repro_torch.data.metrics import span
from repro_torch.kernels.art import kernel, ref

_ENQUEUE = threading.Lock()
# (thread, end event) of each CUDA sweep enqueued and not yet seen finished,
# guarded by _ENQUEUE
_enqueued: list[tuple[int, Any]] = []


def _in_flight(pending: list[tuple[int, Any]], thread: int) -> int:
    """Drops from ``pending`` the sweeps whose end event has passed and
    returns how many of the rest other threads than ``thread`` enqueued."""
    pending[:] = [(t, ev) for t, ev in pending if not ev.query()]
    return sum(t != thread for t, _ in pending)


def inverse_row_norms(A: torch.Tensor) -> torch.Tensor:
    """``1/‖A_j‖²``, 0 for an empty row, as ``repro/kernels/art/ops.py:19-20``
    computes it."""
    rip = (A * A).sum(dim=1)
    return torch.where(rip > 0, 1.0 / torch.clamp(rip, min=1e-12),
                       torch.zeros_like(rip))


def csr_rows(A: torch.Tensor) -> kernel.CSR:
    """The non-zeros of a dense fp32 (nrow, ncol) ``A`` as CSR on ``A``'s
    device, in row-major order (columns ascending within a row): int64 row
    pointers, int32 columns, fp32 values. Built once per geometry; an empty
    row has no entries."""
    if A.dim() != 2 or A.dtype != torch.float32:
        raise ValueError(f"csr_rows: A must be a 2-D float32 matrix, got "
                         f"{A.dtype} {tuple(A.shape)}")
    nrow, ncol = A.shape
    if ncol >= 2**31:
        raise ValueError(f"csr_rows: {ncol} columns do not fit int32")
    nz = A != 0
    row_ptr = torch.zeros(nrow + 1, dtype=torch.int64, device=A.device)
    row_ptr[1:] = nz.sum(dim=1).cumsum(dim=0)
    col = nz.nonzero()[:, 1].to(torch.int32)
    return kernel.CSR(row_ptr, col, A[nz], (nrow, ncol))


def art_reconstruct(A: torch.Tensor, b: torch.Tensor, f0: torch.Tensor,
                    beta: float = 1.0, iters: int = 1,
                    use_kernel: bool | None = None,
                    inv_rip: torch.Tensor | None = None,
                    csr: kernel.CSR | None = None) -> torch.Tensor:
    """A batch of tilt-series slices: A (nrow, ncol), b (S, nrow), f0
    (S, ncol) -> (S, ncol). ``inv_rip`` and, for the kernel, ``csr`` are
    computed from ``A`` unless the caller passes them (the solver caches
    both with ``A``). ``use_kernel=None`` means the kernel iff ``A`` is on
    CUDA; ``False`` asks for the plain version on either device."""
    if inv_rip is None:
        inv_rip = inverse_row_norms(A)
    if A.is_cuda if use_kernel is None else use_kernel:
        if csr is None:
            csr = csr_rows(A)
        me = threading.get_ident()
        with _ENQUEUE:
            with span("art", device=True,
                      attrs={"in_flight": _in_flight(_enqueued, me)}):
                f = kernel.art_sweep(csr, b, inv_rip, f0, beta, iters)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(A.device))
            _enqueued.append((me, done))
        return f
    with span("art"):
        return ref.art_sweep_ref(A, b, inv_rip, f0, beta, iters)
