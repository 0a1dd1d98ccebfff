"""Rendering stage (paper Figs. 10 and 13-15, ParaView/ParaViewWeb
stand-in).

The counterpart of ``repro/apps/tomo/render.py``, numpy copies:
``render_volume`` saves orthogonal slices and a max-intensity projection
of the gathered volume, ``render_phase`` a reconstructed object's phase
and amplitude, each as NPY and, where matplotlib is installed, as a PNG.
"""
from __future__ import annotations

import os

import numpy as np


def render_volume(volume: np.ndarray, outdir: str, prefix: str = "tomo"
                  ) -> list[str]:
    os.makedirs(outdir, exist_ok=True)
    paths = []
    mid = volume.shape[0] // 2
    views = {
        "slice_z": volume[mid],
        "slice_y": volume[:, volume.shape[1] // 2],
        "mip": volume.max(axis=0),
    }
    np.save(os.path.join(outdir, f"{prefix}_volume.npy"), volume)
    paths.append(os.path.join(outdir, f"{prefix}_volume.npy"))
    try:
        import matplotlib
    except ImportError:        # no matplotlib: the .npy is the artifact
        return paths
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(1, len(views), figsize=(4 * len(views), 4))
    for ax, (name, img) in zip(np.atleast_1d(axes), views.items()):
        ax.imshow(img, cmap="viridis")
        ax.set_title(name)
        ax.axis("off")
    path = os.path.join(outdir, f"{prefix}_views.png")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    paths.append(path)
    return paths


def render_phase(obj: np.ndarray, outdir: str, prefix: str = "ptycho"
                 ) -> list[str]:
    """Paper Fig. 10: the reconstructed object's phase (and amplitude)."""
    os.makedirs(outdir, exist_ok=True)
    phase = np.angle(obj)
    np.save(os.path.join(outdir, f"{prefix}_phase.npy"), phase)
    paths = [os.path.join(outdir, f"{prefix}_phase.npy")]
    try:
        import matplotlib
    except ImportError:        # no matplotlib: the .npy is the artifact
        return paths
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(1, 2, figsize=(9, 4.5))
    axes[0].imshow(phase, cmap="twilight")
    axes[0].set_title("reconstructed phase")
    axes[1].imshow(np.abs(obj), cmap="gray")
    axes[1].set_title("reconstructed amplitude")
    for ax in axes:
        ax.axis("off")
    path = os.path.join(outdir, f"{prefix}_object.png")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    paths.append(path)
    return paths
