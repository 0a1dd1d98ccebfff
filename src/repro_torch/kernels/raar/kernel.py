"""Launch wrapper of the CUDA RAAR-combine kernel (csrc/raar.cu), the
counterpart of ``repro/kernels/raar/kernel.py:raar_combine``."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def raar_combine(psi: torch.Tensor, p1: torch.Tensor, p21: torch.Tensor,
                 p2: torch.Tensor, beta: float = 0.75) -> torch.Tensor:
    """Eq. 7 on four complex64 fields of one shape, contiguous on one CUDA
    device; ``p21`` and ``p2`` may be the same tensor. ``beta`` is a runtime
    argument."""
    op = "raar_combine"
    _build.check_tensor(op, "psi", psi, torch.complex64, psi.shape)
    for name, t in (("p1", p1), ("p21", p21), ("p2", p2)):
        _build.check_tensor(op, name, t, torch.complex64, psi.shape,
                            psi.device)
    out = torch.empty_like(psi)
    lib = _build.load_library()
    with torch.cuda.device(psi.device):
        rc = lib.raar_combine_launch(
            psi.data_ptr(), p1.data_ptr(), p21.data_ptr(), p2.data_ptr(),
            out.data_ptr(), psi.numel(), float(beta),
            _build.current_stream(psi.device))
    _build.check_launch(op, rc)
    with _build.COUNT_LOCK:
        raar_combine.launches += 1
    return out


raar_combine.launches = 0
