"""RAAR ptychographic solver (the SHARP program, paper §III), the
counterpart of ``repro/apps/ptycho/solver.py``.

Per iteration (SHARP schedule — one overlap solve per iteration):

  1. π₁ (modulus):  ψ₁ = F⁻¹[ mag · Fψ / |Fψ| ]            (CUDA kernel)
  2. overlap update (eqs. 4–5): new probe P and object O from ψ₁. The
     per-frame products are a kernel; the scatter-add onto the object
     canvas is ``index_put_(accumulate=True)``, and with a process
     ``group`` the partial sums are all-reduced (MPI_Allreduce).  (CUDA kernel)
  3. π₂ψ₁ = P·O_patch  with the updated P, O.
  4. RAAR combine (eq. 7): ψ ← 2βπ₂π₁ψ + (1-2β)π₁ψ + β(ψ-π₂ψ)
     with π₂ψ ≈ π₂π₁ψ under the fixed-(P,O) projector — SHARP's
     single-overlap approximation, kept as the reference has it. (CUDA kernel)

Kernels run iff the tensors are on CUDA, unless ``SolverConfig.
use_cuda_kernels`` says otherwise; on the CPU the plain versions run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.apps.ptycho.sim import PtychoProblem, accumulate_patches
from repro_torch.apps.ptycho.sim import patch_indices as _patch_indices
from repro_torch.kernels.modulus import ops as modulus_ops
from repro_torch.kernels.overlap import ops as overlap_ops
from repro_torch.kernels.raar import ops as raar_ops


@dataclass
class SolverConfig:
    beta: float = 0.75
    iterations: int = 100
    probe_update_start: int = 2     # iterations of object-only updates first
    eps: float = 1e-6
    # None = the CUDA kernels iff the tensors are on CUDA; False = the plain
    # versions on either device (the card's reference path)
    use_cuda_kernels: bool | None = None


def _allreduce(t: torch.Tensor, group: Any) -> torch.Tensor:
    """Sum across the ranks of ``group`` in place; a no-op without one."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def overlap_update(psi: torch.Tensor, positions: np.ndarray | torch.Tensor,
                   probe: torch.Tensor, obj_shape: tuple[int, int],
                   eps: float = 1e-6, group: Any = None,
                   update_probe: bool = True,
                   use_kernel: bool | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eqs. (4)–(5): closed-form O and P from exit waves ψ.

    With ``group``, the partial sums are all-reduced across its ranks — the
    paper's MPI_Allreduce (Fig. 9)."""
    F, h, w = psi.shape
    iy, ix = _patch_indices(positions, h, psi.device)

    # object update: O = Σ ψ_j P* / Σ |P|², the probe read in place
    num_o, den_o = overlap_ops.overlap_products(psi, probe,
                                                use_kernel=use_kernel)
    num = accumulate_patches(
        torch.zeros(obj_shape, dtype=psi.dtype, device=psi.device),
        iy, ix, num_o)
    den = accumulate_patches(
        torch.zeros(obj_shape, dtype=torch.float32, device=psi.device),
        iy, ix, den_o)
    _allreduce(num, group)
    _allreduce(den, group)
    obj = num / (den + eps)

    if not update_probe:
        return obj, probe
    # probe update: P = Σ ψ_j O*_patch / Σ |O_patch|²
    patches = obj[iy, ix]
    num_p, den_p = overlap_ops.overlap_products(psi, patches,
                                                use_kernel=use_kernel)
    nump = _allreduce(torch.sum(num_p, dim=0), group)
    denp = _allreduce(torch.sum(den_p, dim=0), group)
    new_probe = nump / (denp + eps)
    return obj, new_probe


def raar_step(psi: torch.Tensor, mag: torch.Tensor,
              positions: np.ndarray | torch.Tensor, probe: torch.Tensor,
              obj_shape: tuple[int, int], config: SolverConfig,
              iteration: int = 0, group: Any = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """One RAAR iteration. Returns (psi', obj, probe, fourier_error)."""
    uk = config.use_cuda_kernels
    # π₁: modulus projection
    far = torch.fft.fft2(psi)
    err = _allreduce(torch.sum(torch.square(torch.abs(far) - mag)), group)
    norm = _allreduce(torch.sum(torch.square(mag)), group)
    far_proj = modulus_ops.modulus_project(far, mag, use_kernel=uk)
    psi1 = torch.fft.ifft2(far_proj)

    # overlap (eqs. 4-5) on the projected waves
    obj, new_probe = overlap_update(
        psi1, positions, probe, obj_shape, config.eps, group,
        update_probe=int(iteration) >= config.probe_update_start,
        use_kernel=uk)

    # π₂π₁ψ with the refreshed (P, O)
    iy, ix = _patch_indices(positions, psi.shape[-1], psi.device)
    p21 = new_probe[None] * obj[iy, ix]

    # RAAR combine (eq. 7); π₂ψ ≈ π₂π₁ψ under the fixed-(P,O) projector
    new_psi = raar_ops.raar_combine(psi, psi1, p21, p21, config.beta,
                                    use_kernel=uk)
    rel_err = torch.sqrt(err / torch.clamp(norm, min=1e-12))
    return new_psi, obj, new_probe, rel_err


def init_waves(problem_mag: torch.Tensor, probe: torch.Tensor
               ) -> torch.Tensor:
    """ψ⁰: probe modulated by random phases, scaled to measured power."""
    F, h, w = problem_mag.shape
    power = torch.sqrt(torch.mean(torch.square(problem_mag), dim=(1, 2)))
    base = probe[None] * (power / (torch.mean(torch.abs(probe)) * h * w
                                   + 1e-9))[:, None, None]
    return base.to(torch.complex64)


def initial_probe(probe_true: torch.Tensor) -> torch.Tensor:
    """The reference's starting probe: the true probe under a random phase
    screen drawn from ``np.random.default_rng(0)``, in complex64 on the
    host, so both packages start from the same point."""
    truth = probe_true.cpu().numpy()
    screen = np.exp(1j * 0.5 * np.random.default_rng(0).standard_normal(
        truth.shape)).astype(np.complex64)
    return torch.from_numpy(truth * screen).to(probe_true.device)


def reconstruct(problem: PtychoProblem, config: SolverConfig
                ) -> dict[str, Any]:
    """Single-device reference reconstruction (tests, small problems)."""
    probe = initial_probe(problem.probe_true)
    psi = init_waves(problem.magnitudes, probe)
    positions = torch.as_tensor(problem.positions, device=psi.device)
    obj_shape = tuple(problem.object_true.shape)
    errs, obj = [], None
    for it in range(config.iterations):
        psi, obj, probe, err = raar_step(psi, problem.magnitudes, positions,
                                         probe, obj_shape, config, it)
        errs.append(err)
    return {"object": obj, "probe": probe, "errors": torch.stack(errs),
            "psi": psi}


def reconstruction_quality(obj: torch.Tensor | np.ndarray,
                           truth: torch.Tensor | np.ndarray,
                           margin: int = 48) -> float:
    """Phase correlation against ground truth on the interior (global phase
    offset removed) — a scalar in [-1, 1]."""
    o = _host(obj)[margin:-margin, margin:-margin]
    t = _host(truth)[margin:-margin, margin:-margin]
    # remove global phase
    offset = np.angle(np.vdot(t, o))
    o = o * np.exp(-1j * offset)
    po, pt = np.angle(o), np.angle(t)
    po -= po.mean()
    pt -= pt.mean()
    denom = np.sqrt((po**2).sum() * (pt**2).sum()) + 1e-12
    return float((po * pt).sum() / denom)


def _host(x: torch.Tensor | np.ndarray) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
