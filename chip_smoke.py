#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:   python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi) and torch's version;
  2. the nvcc build of src/repro_torch/csrc/*.cu, with its seconds;
  3. each CUDA kernel against its plain PyTorch version on the card, at the
     main path's shapes (512 frames of 64x64), timed with CUDA events beside
     the least time the card could take (bytes over 3.35 TB/s);
  4. one RAAR step at paper size with the kernels against the plain path;
  5. the §III stream at the paper's Table II size (512 frames, 256x256
     object, 64x64 probe, scan step 8) through ``run_stream``, with its
     quality, the kernels' launch counts and the sink's contents checked;
  6. a profile of RAAR steps at 512 frames: device time by kernel.
It then prints a JSON line of the kernels, the nvidia-smi line again, and
as its last line {"ok": true, "device": {...}}. Without a GPU, or outside
a checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "build" / "chip_smoke"
SEED = 0
F, H, W = 512, 64, 64               # the main path's largest batch
PAPER_ARGS = ["--frames", "512", "--obj-size", "256", "--probe-size", "64",
              "--scan-step", "8"]
# H100 SXM (NVIDIA data sheet): device memory rate, and the fp32 rate
# outside the tensor cores
MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
MAX_FINAL_ERROR = 0.10              # the JAX reference reaches 0.0865 here
MIN_QUALITY = 0.92                  # ... and 0.943
OWN_KERNELS = ("modulus_project_kernel", "overlap_products_kernel",
               "raar_combine_kernel")


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _time_ms(torch, fn, reps: int = 25, warmup: int = 3,
             flush=None) -> float:
    """Median device time of ``fn`` in ms, by CUDA events around each call.
    ``flush`` runs before each call, outside the events, to empty the L2."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        if flush is not None:
            flush()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def _bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _max_err(torch, got, want) -> float:
    return float((got - want).abs().max())


def _without_launches(variants: list[dict]) -> list[dict]:
    """Per-variant rows; launches are counted per kernel, not per variant."""
    return [{k: v for k, v in row.items() if k != "launches"}
            for row in variants]


def kernel_phase(torch, dev, flush) -> list[dict]:
    import numpy as np

    from repro_torch.kernels.modulus import kernel as mk
    from repro_torch.kernels.modulus import ref as mr
    from repro_torch.kernels.overlap import kernel as ok
    from repro_torch.kernels.overlap import ref as orf
    from repro_torch.kernels.raar import kernel as rk
    from repro_torch.kernels.raar import ref as rr

    rng = np.random.default_rng(SEED)

    def cplx(*shape):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(z.astype(np.complex64)).to(dev)

    n = F * H * W
    check = dict(rtol=1e-6, atol=1e-6)
    rows = []

    def measure(name, source, replaces, call, plain, nbytes, ops, tol,
                extra=()):
        got, want = call(), plain()
        torch.cuda.synchronize()
        outs = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err = 0.0
        for g, w in zip(*outs):
            torch.testing.assert_close(g, w, **tol)
            err = max(err, _max_err(torch, g, w))
        for g, w, t in extra:
            torch.testing.assert_close(g, w, **t)
        ms = _time_ms(torch, call, flush=flush)
        plain_ms = _time_ms(torch, plain, flush=flush)
        bound, by = _bound_ms(nbytes, ops)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": by, "library_ms": None}
        print(f"  {name:34s} max|err| {err:.3g}  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  bound {bound:.4f} ms ({by})  "
              f"library n/a")
        return row

    # modulus: 8 B far + 4 B mag in, 8 B out; 8 operations an element
    far = cplx(F, H, W)
    mag = torch.from_numpy(
        np.abs(rng.standard_normal((F, H, W))).astype(np.float32)).to(dev)
    rows.append(measure(
        "modulus_project", "src/repro_torch/csrc/modulus.cu",
        "src/repro/kernels/modulus/kernel.py:35",
        lambda: mk.modulus_project(far, mag),
        lambda: mr.modulus_project_ref(far, mag), n * 20, n * 8, check))

    # overlap: probe update (b per frame, 28 B) and object update (b the
    # shared probe, 20 B); 9 operations an element
    a, b, probe = cplx(F, H, W), cplx(F, H, W), cplx(H, W)
    variants = []
    for label, bb, nbytes in (("probe update", b, n * 28),
                              ("object update", probe, n * 20 + H * W * 8)):
        complex_form = (a * bb.conj(), (bb.abs() ** 2).expand(a.shape))
        got = ok.overlap_products(a, bb)
        extra = [(got[0], complex_form[0], dict(rtol=1e-5, atol=1e-5)),
                 (got[1], complex_form[1], dict(rtol=1e-5, atol=1e-5))]
        variants.append(measure(
            f"overlap_products ({label})",
            "src/repro_torch/csrc/overlap.cu",
            "src/repro/kernels/overlap/kernel.py:34",
            lambda bb=bb: ok.overlap_products(a, bb),
            lambda bb=bb: orf.overlap_products_ref(a, bb), nbytes, n * 9,
            check, extra))
    row = dict(variants[0], name="overlap_products",
               max_abs_err=max(v["max_abs_err"] for v in variants),
               variants=_without_launches(variants))
    rows.append(row)

    # raar: four 8 B inputs, one 8 B output; 12 operations an element
    psi, p1, p21, p2 = (cplx(F, H, W) for _ in range(4))
    variants = []
    for beta in (0.5, 0.75, 0.9):
        aliased = (rk.raar_combine(psi, p1, p21, p21, beta),
                   rr.raar_combine_ref(psi, p1, p21, p21, beta), check)
        variants.append(measure(
            f"raar_combine (beta {beta})", "src/repro_torch/csrc/raar.cu",
            "src/repro/kernels/raar/kernel.py:32",
            lambda beta=beta: rk.raar_combine(psi, p1, p21, p2, beta),
            lambda beta=beta: rr.raar_combine_ref(psi, p1, p21, p2, beta),
            n * 40, n * 12, check, [aliased]))
    row = dict(variants[1], name="raar_combine",
               max_abs_err=max(v["max_abs_err"] for v in variants),
               variants=_without_launches(variants))
    rows.append(row)
    return rows


def step_phase(torch, dev, problem) -> None:
    """One RAAR step at paper size, kernels against the plain path on the
    card, at iterations 0 (object only) and 5 (object and probe)."""
    from repro_torch.apps.ptycho.solver import (SolverConfig, init_waves,
                                                raar_step)
    mags = problem.magnitudes[:F]
    pos = torch.as_tensor(problem.positions[:F], device=dev)
    probe = problem.probe_true
    psi = init_waves(mags, probe)
    shape = tuple(problem.object_true.shape)
    plain, kern = SolverConfig(use_cuda_kernels=False), SolverConfig()
    for it in (0, 5):
        want = raar_step(psi, mags, pos, probe, shape, plain, it)
        got = raar_step(psi, mags, pos, probe, shape, kern, it)
        errs = []
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)
            errs.append(_max_err(torch, g, w))
        ms = _time_ms(torch, lambda: raar_step(psi, mags, pos, probe, shape,
                                               kern, it), reps=10)
        plain_ms = _time_ms(torch, lambda: raar_step(
            psi, mags, pos, probe, shape, plain, it), reps=10)
        print(f"  raar_step iteration {it} at {F} frames: kernels vs plain "
              f"max|err| psi {errs[0]:.3g} obj {errs[1]:.3g} probe "
              f"{errs[2]:.3g} err {errs[3]:.3g} (tol 2e-4); step "
              f"{ms:.3f} ms with kernels, {plain_ms:.3f} ms plain")


def profile_phase(torch, dev, problem) -> None:
    """Device time by kernel over a few RAAR steps at 512 frames."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.apps.ptycho.solver import (SolverConfig, init_waves,
                                                raar_step)
    mags = problem.magnitudes[:F]
    pos = torch.as_tensor(problem.positions[:F], device=dev)
    probe = problem.probe_true
    psi = init_waves(mags, probe)
    shape, cfg, steps = tuple(problem.object_true.shape), SolverConfig(), 5

    def run():
        state = (psi, probe)
        for _ in range(steps):
            out = raar_step(state[0], mags, pos, state[1], shape, cfg, 5)
            state = (out[0], out[2])
        torch.cuda.synchronize()

    run()                                  # warm-up
    t0 = time.perf_counter()               # wall time without the profiler
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = (kernels.get(ev.name, 0.0)
                                + ev.device_time_total)
    busy_ms = sum(kernels.values()) / 1e3
    if busy_ms == 0:
        print("  profile: the profiler saw no device time (not measured)")
        return
    own_ms = sum(us for name, us in kernels.items()
                 if any(k in name for k in OWN_KERNELS)) / 1e3
    print(f"  {steps} raar_steps at {F} frames: wall {wall_ms:.3f} ms "
          f"unprofiled; device busy {busy_ms:.3f} ms (profiled), idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; the port's kernels "
          f"{own_ms / steps:.4f} ms/step")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3 / steps:9.4f} ms/step "
              f"{100 * us / 1e3 / busy_ms:5.1f}%  {name[:90]}")


def stream_phase(torch, dev) -> dict:
    from repro_torch import kernels
    from repro_torch.apps.ptycho.stream import parse_args, run_stream

    shutil.rmtree(OUT, ignore_errors=True)
    args = parse_args(PAPER_ARGS + ["--out", str(OUT)])
    kernels.reset_launch_counts()
    res = run_stream(args, device=dev)
    counts = kernels.launch_counts()
    steps = res["iterations"]
    expect = {"modulus_project": steps, "raar_combine": steps,
              # the probe update's second launch from iteration 2 on
              "overlap_products": 2 * steps - min(steps, 2)}
    print(f"  steps {steps}, launches {counts}, expected {expect}")
    if counts != expect or res["launches"] != expect:
        raise AssertionError(f"launch counts {counts} (run_stream reports "
                             f"{res['launches']}) != expected {expect}")
    if not all(math.isfinite(e) for e in res["batch_errors"]):
        raise AssertionError(f"bad batch errors {res['batch_errors']}")
    if not res["final_error"] <= MAX_FINAL_ERROR:
        raise AssertionError(f"final Fourier error {res['final_error']} > "
                             f"{MAX_FINAL_ERROR}")
    if not res["quality"] >= MIN_QUALITY:
        raise AssertionError(f"phase correlation {res['quality']} < "
                             f"{MIN_QUALITY}")
    batches = len(res["batch_errors"])
    want_keys = [f"batch-{i:06d}" for i in range(batches)] + ["object-final"]
    if res["sink_keys"] != want_keys:
        raise AssertionError(f"sink holds {res['sink_keys']}, expected "
                             f"{want_keys}")
    in_batches = sum(res["batch_times"])
    print(f"  wall time: batches {in_batches:.3f} s (device work "
          f"included), rest of the stream {res['stream_time'] - in_batches:.3f}"
          f" s (pump, broker, sinks, the drain wait), refinement "
          f"{res['total_time'] - res['stream_time']:.3f} s")
    print(f"  stream OK: {batches} batches, batch times (s) "
          f"{[round(t, 4) for t in res['batch_times']]}, setup "
          f"{res['setup_time']:.3f} s, stream {res['stream_time']:.3f} s, "
          f"total {res['total_time']:.3f} s vs acquisition window "
          f"{res['acquisition_window']:.1f} s -> near-real-time "
          f"{res['near_real_time']}; final error {res['final_error']:.4f} "
          f"(<= {MAX_FINAL_ERROR}), quality {res['quality']:.4f} "
          f"(>= {MIN_QUALITY})")
    return counts


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "_build.py").is_file():
        print("chip_smoke: no src/repro_torch next to this script; run it "
              "from the root of a checkout", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; one NVIDIA "
              "GPU is needed", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.apps.ptycho.sim import simulate
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    smi = _nvidia_smi()
    print(f"[1] card: {smi}; torch {torch.__version__} "
          f"(CUDA {torch.version.cuda})", flush=True)

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    print(f"[2] {lib.relative_to(ROOT)} loaded in "
          f"{time.perf_counter() - t0:.2f} s, nvcc's build included when "
          f"the log line above says it built", flush=True)

    # a 256 MB buffer zeroed between timed calls empties the 50 MB L2, and
    # keeps the device busy while the host enqueues the next call
    l2_flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    print(f"[3] kernels against their plain versions at {F}x{H}x{W} "
          f"(tol 1e-6, overlap against the complex form 1e-5):", flush=True)
    rows = kernel_phase(torch, dev, l2_flush.zero_)
    del l2_flush

    problem = simulate(256, 64, 8, device=dev)
    print("[4] raar_step at paper size, kernels against the plain path:",
          flush=True)
    step_phase(torch, dev, problem)

    print("[5] the stream at paper size:", flush=True)
    counts = stream_phase(torch, dev)
    for row in rows:
        row["launches"] = counts[row["name"]]

    print("[6] where a RAAR step's device time goes:", flush=True)
    profile_phase(torch, dev, problem)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
