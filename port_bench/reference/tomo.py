"""Plain reference of the §IV tilt-series reconstruction, and the inputs.

Nothing here imports the program. The benchmark makes the tilt series from
the seed with ``phantom`` and ``projection_matrix`` and hands the same
sinogram rows to the program and to ``art``; the program builds its own
system matrix, its CSR and row norms, and this module works them out
again from the geometry.

* ``phantom``: nested random ellipsoids in a unit ball, as the paper's
  example draws them (``examples/tomo_pipeline.py``'s phantom), from a
  numpy generator seeded with the run's seed, evaluated on the device.
* ``projection_matrix``: the parallel-ray system A ∈ R^{(angles·nray) ×
  nray²} of ``parallelRay`` (paper Fig. 12): row (θ, r) samples the ray at
  angle θ and detector offset r at 2·nray points and spreads each sample
  over its four neighbouring pixels by bilinear weights times the step.
* ``art``: the Kaczmarz row-action sweep, for each row j in order and
  every slice s, ``f_s += beta * ((b_sj - <A_j, f_s>) * inv_rip_j) *
  A_j``, over each row's non-zeros, in fp32 with every product in full
  fp32. ``tf32=True`` rounds the products' operands to TF32 (10 mantissa
  bits, round to nearest) first: the control, one precision step below
  the configuration's.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def phantom(nslice: int, nray: int, seed: int, device: torch.device,
            ellipsoids: int = 6) -> torch.Tensor:
    """(nslice, nray, nray) fp32: ``ellipsoids`` ellipsoids of random
    centre, radii and density summed, zero outside radius 0.95."""
    rng = np.random.default_rng(seed)
    axes = [((torch.arange(n, dtype=torch.float64, device=device) - n / 2)
             / (n / 2)) for n in (nslice, nray, nray)]
    z = axes[0][:, None, None]
    y = axes[1][None, :, None]
    x = axes[2][None, None, :]
    vol = torch.zeros((nslice, nray, nray), dtype=torch.float64,
                      device=device)
    for _ in range(ellipsoids):
        c = rng.uniform(-0.4, 0.4, 3)
        r = rng.uniform(0.15, 0.5, 3)
        a = rng.uniform(0.2, 1.0)
        inside = (((z - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2
                  + ((x - c[2]) / r[2]) ** 2) < 1.0
        vol += a * inside
    vol[(z ** 2 + y ** 2 + x ** 2) > 0.95] = 0.0
    return vol.to(torch.float32)


def angles_deg(count: int, half_range: float) -> np.ndarray:
    """``count`` tilt angles evenly over ±``half_range`` degrees."""
    return np.linspace(-half_range, half_range, count)


def projection_matrix(nray: int, angles: np.ndarray, device: torch.device
                      ) -> torch.Tensor:
    """The dense fp32 system A, built on ``device``: the geometry in
    float64, each sample's four weights rounded to fp32, then summed into
    their pixels."""
    n, nsamp = nray, 2 * nray
    ts = torch.linspace(-n / 2, n / 2, nsamp, dtype=torch.float64,
                        device=device)
    step = float(ts[1] - ts[0])
    offs = torch.arange(n, dtype=torch.float64, device=device) - n / 2 + 0.5
    A = torch.zeros((len(angles) * n, n * n), dtype=torch.float32,
                    device=device)
    rows = torch.arange(n, device=device)[:, None].expand(n, nsamp)
    for ai, theta in enumerate(np.deg2rad(np.asarray(angles, np.float64))):
        d = (math.cos(theta), math.sin(theta))          # along the ray
        o = (-math.sin(theta), math.cos(theta))         # detector axis
        ys = offs[:, None] * o[0] + ts[None, :] * d[0] + n / 2 - 0.5
        xs = offs[:, None] * o[1] + ts[None, :] * d[1] + n / 2 - 0.5
        y0, x0 = torch.floor(ys), torch.floor(xs)
        fy, fx = ys - y0, xs - x0
        y0, x0 = y0.long(), x0.long()
        for dy, dx, w in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                          (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
            yy, xx = y0 + dy, x0 + dx
            ok = (yy >= 0) & (yy < n) & (xx >= 0) & (xx < n)
            A.index_put_((ai * n + rows[ok], yy[ok] * n + xx[ok]),
                         (w[ok] * step).to(torch.float32), accumulate=True)
    return A


def padded_rows(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """A's non-zeros row by row, padded to the longest row: columns
    (nrow, m) int64 (0 past a row's end), values (nrow, m) fp32 (0 past
    its end), and ``1/‖A_j‖²`` (0 for an empty row)."""
    nz = A != 0
    counts = nz.sum(dim=1)
    m = max(int(counts.max()), 1)
    r, c = nz.nonzero(as_tuple=True)
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(r.numel(), device=A.device) - start[r]
    cols = torch.zeros((A.shape[0], m), dtype=torch.int64, device=A.device)
    vals = torch.zeros((A.shape[0], m), dtype=torch.float32, device=A.device)
    cols[r, slot] = c
    vals[r, slot] = A[r, c]
    rip = (A * A).sum(dim=1)
    inv = torch.where(rip > 0, 1.0 / torch.clamp(rip, min=1e-12),
                      torch.zeros_like(rip))
    return cols, vals, inv


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10 mantissa bits, to nearest (ties away)."""
    bits = x.view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def art(b: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
        inv: torch.Tensor, ncol: int, iters: int, beta: float = 1.0,
        tf32: bool = False) -> torch.Tensor:
    """b (S, nrow) -> f (S, ncol) from zero after ``iters`` sweeps."""
    f = torch.zeros((b.shape[0], ncol), dtype=torch.float32, device=b.device)
    w_dot = to_tf32(vals) if tf32 else vals
    for _ in range(iters):
        for j in range(b.shape[1]):
            c = cols[j]
            g = f[:, c]
            if tf32:
                g = to_tf32(g)
            dot = (g * w_dot[j]).sum(dim=1)
            coef = beta * ((b[:, j] - dot) * inv[j])
            f.index_add_(1, c, coef[:, None] * vals[j][None, :])
    return f
