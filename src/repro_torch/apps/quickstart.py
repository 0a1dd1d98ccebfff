"""Quickstart: the Spark-MPI pattern in one page (paper Figs. 5-6).

The counterpart of ``examples/quickstart.py``. An RDD holds one array a
rank, and it is reduced two ways:
  1. the Spark driver-worker path (every partition collected to the
     driver and summed there, on the host);
  2. the Spark-MPI path (an in-place all-reduce over the bridge's ranks,
     on the device).
Both give the same numbers; the paper's Table I shows why path 2 wins.

Run:  PYTHONPATH=src python -m repro_torch.apps.quickstart
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.bridge import TorchBridge
from repro_torch.core.rdd import Context
from repro_torch.utils import resolve_device

N = 2_000_000                      # the paper's 2M-float payload


def make_payload(n: int = N) -> np.ndarray:
    """Figs. 5-6: every rank holds arange(n) with the sentinel 5.0 last."""
    buf = np.arange(n, dtype=np.float32)
    buf[-1] = 5.0
    return buf


def run_quickstart(n: int = N, bridge: TorchBridge | None = None,
                   device: str | torch.device = "cuda") -> dict[str, Any]:
    """Both reductions of the payload over ``bridge`` (one rank on
    ``device`` without one); raises if they disagree. Returns the world and
    both buffers, the driver's on the host and the bridge's on its
    device."""
    bridge = bridge or TorchBridge(device=resolve_device(device))
    rdd = Context().from_partitions([make_payload(n)
                                     for _ in range(bridge.world)])
    driver_sum = TorchBridge.driver_reduce(rdd)
    mpi_sum = bridge.allreduce(rdd)
    mpi_host = mpi_sum.cpu().numpy()
    print(f"world={bridge.world}")
    print(f"driver path : buffer[-1] = {driver_sum[-1]:.1f}")
    print(f"spark-mpi   : buffer[-1] = {mpi_host[-1]:.1f}")
    if not np.allclose(driver_sum, mpi_host):
        raise AssertionError("the driver and the all-reduce disagree")
    print("identical results; the paper's Table I says which path wins")
    return {"world": bridge.world, "driver": driver_sum, "mpi": mpi_sum}


def main() -> None:
    run_quickstart()


if __name__ == "__main__":
    main()
