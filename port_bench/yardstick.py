"""The benchmark's own arithmetic: peaks, rates, tails, spreads, and the
operation and byte counts behind every roofline and utilisation share.

Nothing here imports the program. The counts are frozen copies of the
formulas they name, so that a later change to the program cannot move the
yardstick it is measured by:

* ``dense_param_count`` and ``model_flops_train`` / ``model_flops_prefill``
  freeze ``repro_torch/launch/dryrun.py:model_param_counts`` and
  ``model_flops`` for the dense family (6·N·D and the causal half of the
  attention for training, 2·N·D and its half for a prefill).
* ``art_bytes`` and ``art_flops`` count what one ART call needs: the CSR
  once a sweep, the sinogram rows and the row norms once, the volume in and
  out (the bound of ``chip_smoke.py``'s phase 7 and PERF.md's kernel table).
* ``flash_flops`` and ``flash_bytes`` count one causal prefill attention
  call in the model layout, K and V repeated to every head as the program
  hands them to the kernel.
* ``spread`` is the quartile spread of PERF.md's bound rule: the distance
  between the first and third quartile of ``statistics.quantiles(values,
  n=4)``, as a share of the median.
"""
from __future__ import annotations

import math
import statistics
from typing import Sequence

# NVIDIA H100 SXM, the data sheet's dense rates at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


# -- rates and tails -----------------------------------------------------------
def rate(count: float, seconds: float) -> float | None:
    """All the work of a window over all of its time; None without time."""
    return count / seconds if seconds > 0 else None


def percentile(values: Sequence[float], q: float) -> float | None:
    """The ``q``-th percentile (0-100) over every value, by linear
    interpolation between the closest ranks (numpy's default, written out
    here); None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median, by ``statistics.quantiles(values, n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med)


def bound_from(spreads: Sequence[float], factor: float = 5.0,
               floor: float = 0.01, ceiling: float = 0.25) -> float:
    """A bound of ``factor`` times the widest spread, never under ``floor``
    nor over ``ceiling``."""
    return min(max(factor * max(spreads), floor), ceiling)


def share(part: float, whole: float) -> float | None:
    """``part`` over ``whole`` in percent; None without a whole."""
    return 100.0 * part / whole if whole > 0 else None


# -- the dense decoder's counts ----------------------------------------------
def dense_param_count(m: dict) -> int:
    """Parameters of a dense decoder with untied head, gated MLP and
    RMSNorm, from its config's sizes."""
    d, hd = m["d_model"], m["head_dim"]
    h, kh, f, V, L = (m["num_heads"], m["num_kv_heads"], m["d_ff"],
                      m["vocab_size"], m["num_layers"])
    layer = d * h * hd + 2 * d * kh * hd + h * hd * d + 3 * d * f + 2 * d
    return 2 * V * d + L * layer + d


def model_flops_train(m: dict, batch: int, seq: int) -> float:
    """One train step's useful FLOPs: 6·N·tokens plus the causal half of
    the attention, ``6·B·S²·h·hd·L / 2`` (dryrun.py's train formula)."""
    n = dense_param_count(m)
    return (6.0 * n * batch * seq + 6.0 * batch * seq * seq * m["num_heads"]
            * m["head_dim"] * m["num_layers"] / 2)


def model_flops_prefill(m: dict, batch: int, seq: int) -> float:
    """One prefill's useful FLOPs: 2·N·tokens plus ``2·B·S²·h·hd·L / 2``
    (dryrun.py's prefill formula)."""
    n = dense_param_count(m)
    return (2.0 * n * batch * seq + 2.0 * batch * seq * seq * m["num_heads"]
            * m["head_dim"] * m["num_layers"] / 2)


# -- kernels ---------------------------------------------------------------------
def art_bytes(nnz: int, nrow: int, ncol: int, slices: int,
              sweeps: int) -> int:
    """Least bytes of one ART call over ``slices`` slices: the CSR (int32
    columns, fp32 values, int64 row pointers) read once a sweep, the
    sinogram rows and the inverse row norms once, the volume read and
    written once, all fp32."""
    csr = nnz * 8 + (nrow + 1) * 8
    return sweeps * csr + slices * nrow * 4 + nrow * 4 + 2 * slices * ncol * 4


def art_flops(nnz: int, slices: int, sweeps: int) -> float:
    """One ART call's arithmetic: each non-zero a multiply-add in the row's
    dot product and one in its update, a slice, a sweep."""
    return 4.0 * nnz * slices * sweeps


def flash_flops(batch: int, heads: int, seq: int, head_dim: int) -> float:
    """A causal attention call's products, Q·Kᵀ and P·V, over the pairs at
    or below the diagonal: ``4·B·H·hd·S(S+1)/2``."""
    return 4.0 * batch * heads * head_dim * seq * (seq + 1) / 2


def flash_bytes(batch: int, heads: int, seq: int, head_dim: int,
                itemsize: int = 2) -> int:
    """Q, K and V (repeated to every head) read once, the output written
    once."""
    return 4 * batch * seq * heads * head_dim * itemsize


def roofline_seconds(flops: float, nbytes: float, peak_flops: float
                     ) -> float:
    """The least time: the larger of the operations over their peak and
    the bytes over the memory's."""
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES)
