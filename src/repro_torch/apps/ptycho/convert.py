"""Carry the reference's problem and solver state across to the port.

The JAX package keeps a ``PtychoProblem`` and the solver state (waves ψ and
probe P) as arrays; these functions take them as numpy arrays
(``np.asarray`` of each JAX array) and build the port's counterparts on a
torch device, dtypes fixed to what the port's kernels read.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps.ptycho.sim import PtychoProblem
from repro_torch.utils import resolve_device


def _tensor(x: np.ndarray, dtype: np.dtype, device: torch.device
            ) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype, order="C")).to(device)


def problem_from_numpy(object_true: np.ndarray, probe_true: np.ndarray,
                       positions: np.ndarray, magnitudes: np.ndarray,
                       device: str | torch.device = "cuda") -> PtychoProblem:
    """The port's ``PtychoProblem`` from the reference's arrays."""
    dev = resolve_device(device)
    mags = np.array(magnitudes, dtype=np.float32, order="C")
    return PtychoProblem(
        object_true=_tensor(object_true, np.complex64, dev),
        probe_true=_tensor(probe_true, np.complex64, dev),
        positions=np.asarray(positions, dtype=np.int32),
        magnitudes=_tensor(mags, np.float32, dev),
        magnitudes_host=mags)


def waves_from_numpy(psi: np.ndarray, probe: np.ndarray,
                     device: str | torch.device = "cuda"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Solver state (ψ (F, h, w), P (h, w)) as complex64 tensors."""
    dev = resolve_device(device)
    return (_tensor(psi, np.complex64, dev),
            _tensor(probe, np.complex64, dev))
