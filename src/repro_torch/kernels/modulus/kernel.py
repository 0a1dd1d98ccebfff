"""Launch wrapper of the CUDA modulus-projection kernel (csrc/modulus.cu),
the counterpart of ``repro/kernels/modulus/kernel.py:modulus_project``."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def modulus_project(far: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    """far: complex64 (F, H, W); mag: fp32 (F, H, W), both contiguous on one
    CUDA device -> complex64 ``far · mag · rsqrt(|far|² + 1e-12)``."""
    op = "modulus_project"
    _build.check_tensor(op, "far", far, torch.complex64, far.shape)
    _build.check_tensor(op, "mag", mag, torch.float32, far.shape, far.device)
    out = torch.empty_like(far)
    lib = _build.load_library()
    with torch.cuda.device(far.device):
        rc = lib.modulus_project_launch(
            far.data_ptr(), mag.data_ptr(), out.data_ptr(), far.numel(),
            _build.current_stream(far.device))
    _build.check_launch(op, rc)
    with _build.COUNT_LOCK:
        modulus_project.launches += 1
    return out


modulus_project.launches = 0
