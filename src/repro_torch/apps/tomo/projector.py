"""Parallel-ray projection matrix for ART (paper Fig. 12 ``parallelRay``).

The counterpart of ``repro/apps/tomo/projector.py``. The system matrix is
data, as weights are to a model: ``parallel_ray_matrix`` and ``make_system``
are a numpy copy of the reference's, line for line, so both packages build
the same dense A ∈ R^{(Nproj·Nray) × Nray²} (row (θ, r) holds the pixel
weights of the ray at angle θ and detector offset r, sampled along the ray
with bilinear interpolation). ``project`` is a ``torch.matmul`` on the
tensors' device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def parallel_ray_matrix(nray: int, angles_key: tuple) -> np.ndarray:
    angles = np.asarray(angles_key, dtype=np.float64)
    n = nray
    nsamp = 2 * n
    ts = np.linspace(-n / 2, n / 2, nsamp)
    offs = np.arange(n) - n / 2 + 0.5
    A = np.zeros((len(angles) * n, n * n), dtype=np.float32)
    step = ts[1] - ts[0]
    for ai, theta in enumerate(np.deg2rad(angles)):
        d = np.array([np.cos(theta), np.sin(theta)])      # ray direction
        o = np.array([-np.sin(theta), np.cos(theta)])     # detector axis
        for ri, r in enumerate(offs):
            # sample points along the ray
            pts = r * o[None, :] + ts[:, None] * d[None, :] + n / 2 - 0.5
            ys, xs = pts[:, 0], pts[:, 1]
            y0 = np.floor(ys).astype(int)
            x0 = np.floor(xs).astype(int)
            fy, fx = ys - y0, xs - x0
            row = np.zeros(n * n, dtype=np.float32)
            for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)),
                                (0, 1, (1 - fy) * fx),
                                (1, 0, fy * (1 - fx)),
                                (1, 1, fy * fx)):
                yy, xx = y0 + dy, x0 + dx
                ok = (yy >= 0) & (yy < n) & (xx >= 0) & (xx < n)
                np.add.at(row, (yy[ok] * n + xx[ok]),
                          (wgt[ok] * step).astype(np.float32))
            A[ai * n + ri] = row
    return A


def make_system(nray: int, angles: np.ndarray) -> np.ndarray:
    return parallel_ray_matrix(nray, tuple(np.asarray(angles).tolist()))


def project(A: torch.Tensor, volume: torch.Tensor) -> torch.Tensor:
    """Forward-project a (Nslice, Nray, Nray) volume -> tilt series
    (Nslice, Nrow) with Nrow = Nproj·Nray, on the tensors' device.

    A float32 product on the card must run in full float32: a TF32 one
    keeps about three decimal digits and would shift the residual, so this
    raises while ``torch.backends.cuda.matmul.allow_tf32`` is set (it is
    False by default)."""
    if A.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("project: torch.backends.cuda.matmul.allow_tf32 "
                           "is True; the tomography projection needs full "
                           "float32")
    nslice = volume.shape[0]
    flat = volume.reshape(nslice, -1)
    return flat @ A.T
