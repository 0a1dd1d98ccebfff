"""Synthetic ptychography experiment (paper §III), the counterpart of
``repro/apps/ptycho/sim.py``.

Generates a complex object (smooth amplitude, structured phase), a coherent
probe (Gaussian-apodized disk), an overlapping scan grid, and the measured
diffraction magnitudes ``sqrt(I_j) = |F(P · O_patch_j)|`` per eq. (1). The
object, probe and positions come from numpy with the reference's seeds, so
both packages simulate the same experiment; only the FFT runs in torch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy.signal import convolve2d

from repro_torch.utils import resolve_device


@dataclass(frozen=True)
class PtychoProblem:
    object_true: torch.Tensor    # (H, W) complex64
    probe_true: torch.Tensor     # (h, w) complex64
    positions: np.ndarray        # (F, 2) int32 corner positions
    magnitudes: torch.Tensor     # (F, h, w) fp32 = sqrt(I_j), on the device
    # host copy of ``magnitudes`` for sources that read frames on the host
    magnitudes_host: np.ndarray

    @property
    def num_frames(self) -> int:
        return len(self.positions)

    @property
    def frame_shape(self) -> tuple[int, int]:
        return tuple(self.probe_true.shape)


def make_probe(size: int, device: str | torch.device = "cuda"
               ) -> torch.Tensor:
    """Gaussian-apodized circular probe with a quadratic phase (defocus)."""
    y, x = np.mgrid[:size, :size] - size / 2 + 0.5
    r2 = (x**2 + y**2) / (size / 3.5) ** 2
    amp = np.exp(-r2) * (r2 < 4.0)
    phase = 0.8 * r2
    probe = (amp * np.exp(1j * phase)).astype(np.complex64)
    return torch.from_numpy(probe).to(resolve_device(device))


def make_object(size: int, seed: int = 0,
                device: str | torch.device = "cuda") -> torch.Tensor:
    """Smooth random transmission function: amplitude in [0.7, 1],
    phase in [-pi/2, pi/2] with low-frequency structure."""
    rng = np.random.default_rng(seed)

    def smooth(scale):
        small = rng.standard_normal((size // scale, size // scale))
        img = np.kron(small, np.ones((scale, scale)))[:size, :size]
        k = np.ones((5, 5)) / 25.0
        return convolve2d(img, k, mode="same", boundary="symm")

    amp = 0.85 + 0.15 * np.tanh(smooth(8))
    phase = 1.4 * np.tanh(smooth(4)) + 0.6 * np.tanh(smooth(16))
    obj = (amp * np.exp(1j * phase)).astype(np.complex64)
    return torch.from_numpy(obj).to(resolve_device(device))


def scan_grid(obj_size: int, probe_size: int, step: int) -> np.ndarray:
    """Overlapping raster grid of frame corner positions (+ small jitter)."""
    rng = np.random.default_rng(1)
    lim = obj_size - probe_size
    xs = np.arange(0, lim + 1, step)
    pos = np.array([(y, x) for y in xs for x in xs])
    jitter = rng.integers(-step // 4, step // 4 + 1, pos.shape)
    return np.clip(pos + jitter, 0, lim).astype(np.int32)


def patch_indices(positions: np.ndarray | torch.Tensor, frame: int,
                  device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 row and column indices (F, frame, frame) of every patch."""
    pos = torch.as_tensor(positions, device=device).to(torch.int64)
    ar = torch.arange(frame, device=device)
    iy = pos[:, 0, None, None] + ar[None, :, None]
    ix = pos[:, 1, None, None] + ar[None, None, :]
    return iy, ix


def gather_patches(obj: torch.Tensor, positions: np.ndarray | torch.Tensor,
                   frame: int) -> torch.Tensor:
    """(F, h, w) object patches at the scan positions."""
    iy, ix = patch_indices(positions, frame, obj.device)
    return obj[iy, ix]


def accumulate_patches(canvas: torch.Tensor, iy: torch.Tensor,
                       ix: torch.Tensor, values: torch.Tensor
                       ) -> torch.Tensor:
    """``canvas[iy, ix] += values`` in place, overlapping patches summed in
    an order fixed by the indices, so no sum depends on thread timing.

    On CUDA, ``index_put_(accumulate=True)`` sorts the indices and sums
    each run of duplicates in order (a complex canvas is scattered through
    its float view). On the CPU its float path adds with atomics from
    several threads once it has 32,768 values or more, so two runs sum in
    different orders and differ in the last bits, which the RAAR iterations
    then amplify; there ``index_add_`` on the flattened canvas sums
    serially, in index order."""
    if canvas.is_cuda:
        if canvas.is_complex():
            torch.view_as_real(canvas).index_put_(
                (iy, ix), torch.view_as_real(values), accumulate=True)
        else:
            canvas.index_put_((iy, ix), values, accumulate=True)
        return canvas
    flat = (iy * canvas.shape[-1] + ix).expand(values.shape)
    canvas.view(-1).index_add_(0, flat.reshape(-1), values.reshape(-1))
    return canvas


def scatter_add_patches(canvas: torch.Tensor,
                        positions: np.ndarray | torch.Tensor,
                        patches: torch.Tensor) -> torch.Tensor:
    """Σ_j patch_j scattered at its position (the paper's eq. 4/5 sums), as
    a new tensor; ``canvas`` is left as it was."""
    iy, ix = patch_indices(positions, patches.shape[-1], canvas.device)
    return accumulate_patches(canvas.clone(), iy, ix, patches)


def simulate(obj_size: int = 256, probe_size: int = 64, step: int = 12,
             seed: int = 0, photons: float = 0.0,
             device: str | torch.device = "cuda") -> PtychoProblem:
    """Build the synthetic problem; ``photons>0`` adds Poisson noise."""
    dev = resolve_device(device)
    obj = make_object(obj_size, seed, dev)
    probe = make_probe(probe_size, dev)
    positions = scan_grid(obj_size, probe_size, step)
    patches = gather_patches(obj, positions, probe_size)
    exit_waves = probe[None] * patches
    far = torch.fft.fft2(exit_waves)
    intensity = torch.square(torch.abs(far))
    if photons > 0:
        rng = np.random.default_rng(seed + 1)
        scale = photons / torch.clamp(torch.mean(intensity), min=1e-9)
        noisy = (rng.poisson((intensity * scale).cpu().numpy())
                 / scale.cpu().numpy())
        intensity = torch.from_numpy(noisy.astype(np.float32)).to(dev)
    magnitudes = torch.sqrt(intensity).to(torch.float32)
    return PtychoProblem(object_true=obj, probe_true=probe,
                         positions=np.asarray(positions),
                         magnitudes=magnitudes,
                         magnitudes_host=magnitudes.cpu().numpy())
