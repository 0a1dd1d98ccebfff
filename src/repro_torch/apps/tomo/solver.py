"""Partition-parallel ART reconstruction (paper §IV, Figs. 11-12).

The counterpart of ``repro/apps/tomo/solver.py``. The tilt series is
slicewise independent: the stream's partitions each hand a batch of slices
to :func:`reconstruct_slices`, which runs the ART row-action sweep on all of
them in one call (the CUDA kernel ``csrc/art.cu`` over the system's
non-zeros on the card, its plain dense PyTorch version on the CPU). The
batch axis stands where the reference ``jax.vmap``-s one slice's sweep
(``tomo/solver.py:67-73``).

No state or weights cross from one slice to another. The inputs are made
from the seed by numpy copies of the reference's functions (``make_phantom``
here, ``parallel_ray_matrix`` in ``projector.py``), so the JAX package and
the port start from identical arrays; only the projection and the sweep run
in torch, on the device.
"""
from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.apps.tomo.projector import (make_system, parallel_ray_matrix,
                                             project)
from repro_torch.kernels.art import ops as art_ops
from repro_torch.kernels.art.kernel import CSR
from repro_torch.utils import resolve_device


@dataclass(frozen=True)
class TomoConfig:
    nray: int = 64
    angles: tuple = tuple(np.linspace(-75, 75, 25).tolist())
    beta: float = 1.0
    iterations: int = 2


def make_phantom(nslice: int, nray: int, seed: int = 0) -> np.ndarray:
    """Shepp-Logan-ish nested ellipsoids phantom volume."""
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[:nslice, :nray, :nray].astype(np.float64)
    z = (z - nslice / 2) / (nslice / 2)
    y = (y - nray / 2) / (nray / 2)
    x = (x - nray / 2) / (nray / 2)
    vol = np.zeros((nslice, nray, nray))
    for _ in range(6):
        c = rng.uniform(-0.4, 0.4, 3)
        r = rng.uniform(0.15, 0.5, 3)
        a = rng.uniform(0.2, 1.0)
        mask = (((z - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2
                + ((x - c[2]) / r[2]) ** 2) < 1.0
        vol[mask] += a
    vol[((z**2 + y**2 + x**2) > 0.95)] = 0.0
    return vol.astype(np.float32)


class DeviceSystem(NamedTuple):
    A: torch.Tensor                 # dense, for the projection
    inv_rip: torch.Tensor           # 1/‖A_j‖²
    csr: CSR                        # A's non-zeros, for the ART kernel


@functools.lru_cache(maxsize=2)
def _device_system(nray: int, angles: tuple, device: torch.device
                   ) -> DeviceSystem:
    A = torch.from_numpy(make_system(nray, np.asarray(angles))).to(device)
    system = DeviceSystem(A, art_ops.inverse_row_norms(A), art_ops.csr_rows(A))
    if A.is_cuda:       # complete before any executor's own stream reads it
        torch.cuda.current_stream(device).synchronize()
    return system


def system_on_device(config: TomoConfig, device: torch.device
                     ) -> DeviceSystem:
    """``(A, inv_rip, csr)`` on ``device``, built and copied once per
    geometry and device (the counterpart of the reference's per-config
    ``_slice_reconstructor`` cache). ``clear_system_cache`` drops them."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # one cache entry for "cuda" and the tensors' "cuda:<current>"
        device = torch.device("cuda", torch.cuda.current_device())
    # single flight: the scheduler's executors ask at once, and each miss
    # would build its own 4.75 GiB system at full width
    with _system_lock:
        return _device_system(config.nray, tuple(config.angles), device)


_system_lock = threading.Lock()


def clear_system_cache() -> None:
    """Drop the cached systems, on the device and on the host."""
    _device_system.cache_clear()
    parallel_ray_matrix.cache_clear()


def simulate_tilt_series(config: TomoConfig, nslice: int, seed: int = 0,
                         device: str | torch.device = "cuda"
                         ) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Returns (volume_true (Nslice, Nray, Nray) and sinogram
    (Nslice, Nproj·Nray), both on ``device``, and a host copy of the
    sinogram for the source)."""
    vol = torch.from_numpy(make_phantom(nslice, config.nray, seed)).to(
        resolve_device(device))
    sino = project(system_on_device(config, vol.device).A, vol)
    return vol, sino, sino.cpu().numpy()


def reconstruct_slices(sino_slices: torch.Tensor, config: TomoConfig
                       ) -> torch.Tensor:
    """ART-reconstruct a block of slices (one RDD partition's work) on the
    block's device, in one call of the sweep.

    sino_slices: (k, Nrow) -> (k, Nray, Nray)."""
    n = config.nray
    A, inv_rip, csr = system_on_device(config, sino_slices.device)
    f0 = torch.zeros((sino_slices.shape[0], n * n), dtype=torch.float32,
                     device=sino_slices.device)
    f = art_ops.art_reconstruct(A, sino_slices.contiguous(), f0,
                                beta=config.beta, iters=config.iterations,
                                inv_rip=inv_rip, csr=csr)
    return f.reshape(-1, n, n)


def residual(volume: torch.Tensor, sino: torch.Tensor, config: TomoConfig,
             per_slice: bool = False) -> float | np.ndarray:
    """``|A f - b| / |b|`` over the volume, or for each slice with
    ``per_slice=True``, on the tensors' device."""
    diff = project(system_on_device(config, volume.device).A, volume) - sino
    if per_slice:
        return (torch.linalg.vector_norm(diff, dim=1)
                / (torch.linalg.vector_norm(sino, dim=1) + 1e-12)
                ).cpu().numpy()
    return float(torch.linalg.vector_norm(diff)
                 / (torch.linalg.vector_norm(sino) + 1e-12))
