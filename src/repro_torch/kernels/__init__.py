"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel package mirrors ``repro.kernels.<name>``: ``kernel.py`` wraps
the CUDA kernel in ``repro_torch/csrc`` (built by ``_build``), ``ref.py``
is the plain PyTorch version of the same function, and ``ops.py``
dispatches: the kernel for a CUDA tensor, the plain version for a CPU one.
Each wrapper counts its launches in a ``launches`` attribute, under
``_build.COUNT_LOCK`` (executor threads launch), so a run can show that
its main path went through the kernel; the flash wrapper, which
picks one of three kernels, also counts them by design in
``launches_by_design`` and by template instance, (design, head dim), in
``launches_by_instance``.
"""
from __future__ import annotations


def _wrappers() -> dict:
    from repro_torch.kernels.art import kernel as art
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.modulus import kernel as modulus
    from repro_torch.kernels.overlap import kernel as overlap
    from repro_torch.kernels.raar import kernel as raar
    return {"modulus_project": modulus.modulus_project,
            "overlap_products": overlap.overlap_products,
            "raar_combine": raar.raar_combine,
            "art_sweep": art.art_sweep,
            "flash_attention": flash.flash_attention}


def launch_counts() -> dict[str, int]:
    """Kernel name -> launches since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    from repro_torch.kernels._build import COUNT_LOCK
    with COUNT_LOCK:
        for fn in _wrappers().values():
            fn.launches = 0
            for attr in ("launches_by_design", "launches_by_instance"):
                if hasattr(fn, attr):
                    setattr(fn, attr, dict.fromkeys(getattr(fn, attr), 0))
