"""ART quality of the JAX reference at the full tomography size.

Builds the tilt series of the 256-slice phantom at ``nray`` 256 with 76 tilt
angles over ±75° (2° steps) through ``repro.apps.tomo.solver``, reconstructs
every slice with its ``reconstruct_slices`` (``use_pallas=False``, 2 sweeps)
on the CPU, 64 slices a call, and prints the volume's sinogram residual
``|A f - b| / |b|`` and volume error ``|f - v| / |v|``, and the same two
per slice for slices 124-131. ``chip_smoke.py`` holds the port's stream on
the card to these values.

Run:  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/tomo_reference_slices.py

It holds the 4.75 GiB system matrix and a copy of it in host memory, and
takes minutes.
"""
from __future__ import annotations

import json
import time

import numpy as np

NRAY, NANGLES, NSLICE, SWEEPS, CHUNK = 256, 76, 256, 2, 64
SLICES = range(124, 132)


def main() -> None:
    from repro.apps.tomo.projector import make_system, project
    from repro.apps.tomo.solver import (TomoConfig, reconstruct_slices,
                                        residual, simulate_tilt_series)

    cfg = TomoConfig(nray=NRAY,
                     angles=tuple(np.linspace(-75, 75, NANGLES).tolist()),
                     iterations=SWEEPS, use_pallas=False)
    t0 = time.perf_counter()
    vol, sino = simulate_tilt_series(cfg, NSLICE)
    t1 = time.perf_counter()
    rec = np.concatenate([reconstruct_slices(sino[i:i + CHUNK], cfg)
                          for i in range(0, NSLICE, CHUNK)])
    t2 = time.perf_counter()
    A = make_system(cfg.nray, np.asarray(cfg.angles))
    flat = rec.reshape(NSLICE, -1)
    pred = project(A, flat).astype(np.float64)
    b = sino.astype(np.float64)
    v = vol.reshape(NSLICE, -1).astype(np.float64)
    lo, hi = SLICES.start, SLICES.stop
    resid = (np.linalg.norm(pred[lo:hi] - b[lo:hi], axis=1)
             / np.linalg.norm(b[lo:hi], axis=1))
    err = (np.linalg.norm(flat[lo:hi] - v[lo:hi], axis=1)
           / np.linalg.norm(v[lo:hi], axis=1))
    print(f"tilt series {t1 - t0:.1f} s, ART on {NSLICE} slices "
          f"{t2 - t1:.1f} s")
    print(json.dumps({
        "residual": residual(rec, sino, cfg),
        "error": float(np.linalg.norm(flat - v) / np.linalg.norm(v)),
        "slices": [lo, hi - 1],
        "slice_residual": [float(x) for x in resid],
        "slice_error": [float(x) for x in err]}))


if __name__ == "__main__":
    main()
