#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:   python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi) and torch's version;
  2. the nvcc build of src/repro_torch/csrc/*.cu, with its seconds; then
     the kernels PyTorch's ``scaled_dot_product_attention`` runs at the
     model's prefill shape in bf16 and fp32, by the profiler, before any
     other trace;
  3. each CUDA kernel against its plain PyTorch version on the card, at the
     main path's shapes (512 frames of 64x64), timed with CUDA events beside
     the least time the card could take (bytes over 3.35 TB/s);
  4. one RAAR step at paper size with the kernels against the plain path;
  5. the §III stream at the paper's Table II size (512 frames, 256x256
     object, 64x64 probe, scan step 8) through ``run_stream``, with its
     quality, the kernels' launch counts, the sink's contents and its
     artifact lane's report (every batch delivered, none failed) checked;
     with ``--obs-port 0``: the endpoint's ``/metrics.json`` and
     ``/traces`` read over HTTP before ``close()``, one span per committed
     batch, ``stream_records_total`` 512, and each stage's total time and
     share of the spans' total printed;
  6. a profile of RAAR steps at 512 frames: device time by kernel;
  7. the ART kernel over the system's non-zeros (CSR) against its plain
     dense PyTorch version on the card, at the shapes of
     tests/test_kernels.py, at (24, 37), at a dense (8, 1,000) whose rows
     are longer than a warp holds in registers, and at the §IV path's full
     shape (the (19,456 x 65,536) system
     of nray 256 and 76 angles, 8 slices and one sweep, and a stream
     launch's 16 slices and two sweeps), each also against the plain
     version in float64, timed beside its bound and the dense sweep's
     bound; then a launch's time at 16, 128 and 256 slices;
  8. the §IV tomography stream at full width (256 slices of 256x256, 76
     angles, 2 sweeps, 4 partitions) through ``run_stream``, with its
     residual and volume error held to the JAX reference's, the ART
     launches against the partitions processed, and the sink's keys, with
     ``--obs-port 0`` read back as in phase 5 (``stream_records_total``
     256); then a profile of one of its batches: device time and idle
     share;
  9. ptxas's registers, shared memory and spills of the ART kernel and
     the two tensor-core flash kernels, the HGMMA count of the wgmma
     kernel's SASS and the TF32 HMMA count of the tf32x3 kernel's; then
     the three flash-attention kernels against their plain version on the
     card: at the shapes of tests/test_kernels.py the tf32x3 kernel (fp32)
     and the SIMT kernel (bf16); at hd 128 the tf32x3 kernel (every fp32
     call) and the wgmma kernel (every bf16 call) at S 64 and 130 (one
     tile, a ragged last one), 1,000 through ``ops`` and the model's
     prefill (B 4, S 1,024, H 16, hd 128), each timed there beside its
     bound and PyTorch's ``scaled_dot_product_attention`` (timed for the
     table only); the SIMT kernel timed at the model's batch and sequence
     in bf16 at hd 32;
 10. internlm2-1.8b at full width on the card from the seed: a 4 x 1,024
     prompt batch prefilled with the kernel (every launch on the wgmma
     kernel) and with the naive attention, logits and greedy tokens
     compared; then the serve invariant (greedy prefill + decode equals the
     argmax of teacher-forced prefills) in fp32, B 2, S 256, 4 tokens, with
     the kernel on (every launch on the tf32x3 kernel);
 11. the serve stream at full width through ``run_serve``: 16 requests of
     1,024 tokens in batches of 4, 32 tokens out each, in bf16, its
     flash launches counted (4 batches x 24 layers, all on the wgmma
     kernel); then one batch: its
     tokens against the model's own prefill/decode_step loop, the same loop
     with the naive attention (reported: the first differing token of each
     request and the top-2 logit gap there), and a profile: device time by
     kernel and idle share;
 12. the §III restart at Table II size through ``run_restart``: frame ids
     into a durable log, a spawned consumer running windowed RAAR (windows
     of 64 frames, 6 steps each) SIGKILLed mid-window, the resumed run
     in-process; the window set held exactly (8 windows of 64 frames), each
     window's Fourier error held to an uncrashed run of the same window on
     the card (1e-5 relative), the resumed run's launches to the windows it
     fired x 6, and the kill offset, the windows on disk at the crash and
     the produce, reopen and resume times printed beside the card's name
     and power limit;
 13. the remote ingest at the §III frame shape through
     ``run_remote_ingest`` (``--frames 512 --obj-size 448 --probe-size
     64``: 512 of a 625-position scan of 64x64 fp32 frames), once over TCP
     and once over a Unix socket: a spawned detector process on the host
     pumps the frames through ``IngestRunner`` and ``RemoteBroker`` to a
     ``BrokerServer`` here, whose micro-batches go to the card; every frame
     consumed once, none rejected, every produce on a shared-memory frame,
     the producer's lag within its bound, the photon count and peak
     computed on the card held to numpy's over the same frames (1e-5
     relative), and no shared-memory segment left;
 14. (run right after phase 8, while its system is still on the card) a
     §IV consumer-group handoff at full width: phase 8's 256 sinogram rows
     keyed by slice index on a 4-partition topic, two streaming contexts in
     threads of one process in group "tomo" (heartbeat 0.05 s, session
     timeout 0.4 s), each range of a batch reconstructed by the ART kernel
     into a sink keyed by slice; one consumer goes silent after its second
     committed batch, the survivor takes its partitions over, and the
     silent one's late commit is fenced; every slice in the sink, group lag
     0, the volume held to phase 8's slice by slice (1e-6 relative) and to
     the JAX reference's residual and error (1e-3), ART launches only, one
     a range; the handoff gap, the slices processed twice, the generations
     and the stream time printed;
 15. broker HA under the card's consumer through ``run_ha_failover``
     (``--frames 512 --obj-size 448 --probe-size 64``, 2 partitions):
     a durable primary in its own process, its
     follower as the standby, a spawned producer through a
     ``FailoverBroker``, the primary SIGKILLed after frame 256, a consumer
     on its own ``FailoverBroker`` reducing each batch on the card; every
     frame id in the sink, every frame read back from the promoted broker
     equal to the producer's (CRC-32), photons and peak over the
     deduplicated frames held to numpy's over the frames read back (1e-6
     relative), both clients at one failover or more and epoch 1, the
     restarted zombie fenced, no shared-memory segment left, no kernel
     launched; the time from the kill to the next frame produced, the
     resend window's duplicates, the cursors rewound and frames/s printed.
It then prints a JSON line of the kernels (the ART row's
``launches_group_handoff`` is phase 14's count), the nvidia-smi line again,
and as its last line {"ok": true, "device": {...}}. Without a GPU, or outside
a checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
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
RESTART_ARGS = PAPER_ARGS + ["--restart", "--batch-frames", "64",
                             "--iters-per-batch", "6"]
RESTART_WINDOWS, RESTART_WINDOW, RESTART_ITERS = 8, 64, 6
RESTART_RTOL = 1e-5
REMOTE_ARGS = ["--frames", "512", "--obj-size", "448", "--probe-size", "64"]
REMOTE_FRAMES, REMOTE_RTOL = 512, 1e-5
# H100 SXM (NVIDIA data sheet): device memory rate, the fp32 rate outside
# the tensor cores, the dense bf16 and TF32 rates of the tensor cores, and
# the L2's size
MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
TF32_TC_OPS_PER_S = 495e12
L2_BYTES = 50 * 2**20
MAX_FINAL_ERROR = 0.10              # the JAX reference reaches 0.0865 here
MIN_QUALITY = 0.92                  # ... and 0.943
OWN_KERNELS = ("modulus_project_kernel", "overlap_products_kernel",
               "raar_combine_kernel")
ART_KERNEL = "art_csr_kernel"
FLASH_KERNELS = ("flash_attention_kernel", "flash_attention_wgmma_kernel",
                 "flash_attention_tf32x3_kernel")
GEMM_MARKERS = ("gemm", "nvjet", "xmma", "cutlass")    # cuBLAS's kernels
ART_SHAPES = ((8, 16), (20, 12), (32, 64))      # tests/test_kernels.py:93
ART_ODD_SHAPE = (24, 37)        # kept from the dense kernel's checks
# rows of 1,000 non-zeros: past the 32 x 24 pairs a warp holds in
# registers, so the kernel's tail loop runs
ART_LONG_SHAPE = (8, 1000)
ART_TOL = dict(rtol=1e-4, atol=1e-4)            # tests/test_kernels.py:107
NRAY, NANGLES, NSLICE, PARTITIONS = 256, 76, 256, 4
TOMO_ARGS = ["--nray", str(NRAY), "--angles", str(NANGLES), "--nslice",
             str(NSLICE), "--iterations", "2", "--partitions",
             str(PARTITIONS)]
# The JAX reference at TOMO_ARGS: repro.apps.tomo.solver.reconstruct_slices
# (use_pallas=False) on the CPU, printed by tools/tomo_reference_slices.py.
# Sinogram residual |A f - b|/|b| and volume error |f - v|/|v| of the whole
# volume, and of each of slices 124-131.
REF_RESIDUAL, REF_ERROR = 0.4772438704967499, 0.6329998150856019
REF_SLICES = range(124, 132)
REF_SLICE_RESIDUAL = (0.5196922074787964, 0.5103182872600535,
                      0.5006286466844522, 0.4907017190604099,
                      0.4806879313024302, 0.47043846739413936,
                      0.460561056291703, 0.45032384930051644)
REF_SLICE_ERROR = (0.6561629934299793, 0.6542791921408858,
                   0.652562630357193, 0.6505630711609283,
                   0.6492461233015283, 0.6465218432424262,
                   0.642746150133384, 0.6372793810563379)
REF_TOL = 1e-3
FLASH_SHAPES = ((64, 16), (128, 32), (32, 8))    # tests/test_kernels.py:124
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:136
MODEL_B, MODEL_S, MODEL_H, MODEL_HD = 4, 1024, 16, 128
ARCH = "internlm2-1.8b"
# bf16 prefill of the 4 x 1,024 batch, kernel against naive attention: the
# largest last-token logit difference allowed (see PERF.md, §6)
MAX_PREFILL_LOGIT_DIFF = 0.25
SERVE_ARGS = ["--requests", "16", "--batch", "4", "--prompt-len", "1024",
              "--gen", "32", "--seed", str(SEED)]


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


def _bound_ms(nbytes: float, ops: float,
              ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _max_err(torch, got, want) -> float:
    return float((got - want).abs().max())


def _device_us(torch, prof) -> dict:
    """Device time in µs by kernel name over a profiled run (not counting
    the profiler's own step annotations, which it also puts on the device's
    timeline)."""
    kernels = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not ev.name.startswith("ProfilerStep")):
            kernels[ev.name] = (kernels.get(ev.name, 0.0)
                                + ev.device_time_total)
    return kernels


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
    kernels = _device_us(torch, prof)
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
    args = parse_args(PAPER_ARGS + ["--out", str(OUT), "--obs-port", "0"])
    kernels.reset_launch_counts()
    res = run_stream(args, device=dev)
    counts = kernels.launch_counts()
    steps = res["iterations"]
    expect = {"modulus_project": steps, "raar_combine": steps,
              # the probe update's second launch from iteration 2 on
              "overlap_products": 2 * steps - min(steps, 2),
              "art_sweep": 0, "flash_attention": 0}
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
    lane = res["lanes"].get("NpzDirectorySink")
    if (lane is None or lane["delivered"] != batches or lane["failed"]
            or lane["depth"]):
        raise AssertionError(f"artifact lane report {res['lanes']}: expected "
                             f"{batches} delivered, 0 failed, 0 queued")
    print(f"  artifact lane: delivered {lane['delivered']}, failed "
          f"{lane['failed']}, retries {lane['retries']}, max depth "
          f"{lane['max_depth']}, mean latency "
          f"{lane.get('mean_latency_s', 0.0):.6f} s, mean write "
          f"{lane.get('mean_write_s', 0.0):.6f} s")
    obs_report(res, batches, F, STREAM_STAGES | {"delivery_submit"})
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


# the span stages of a stream without checkpoint or window state
STREAM_STAGES = {"pump", "batch_fn", "sinks", "broker_commit"}


def obs_report(res: dict, batches: int, records: int,
               stages: set[str]) -> None:
    """The stream's endpoint as ``run_stream`` read it over HTTP before
    ``close()``: one span per committed batch with epochs 1..batches, the
    stream counters, the stages; each stage's total and share printed."""
    scrape = res["obs"]
    if scrape is None:
        raise AssertionError("run_stream returned no observability scrape")
    spans = scrape["spans"]
    got = (len(spans), scrape["batches"], scrape["records"],
           sum(s["num_records"] for s in spans))
    print(f"  observability endpoint {scrape['url']}: {got[0]} spans "
          f"(epochs {scrape['epochs']}), stream_batches_total {got[1]:.0f}, "
          f"stream_records_total {got[2]:.0f}; read over HTTP and stopped in "
          f"{res['obs_scrape_s'] * 1e3:.2f} ms, outside the stream time")
    if got != (batches, batches, records, records):
        raise AssertionError(f"(spans, batches, records, span records) "
                             f"{got} != {(batches, batches, records, records)}")
    if [s["epoch"] for s in spans] != list(range(1, batches + 1)):
        raise AssertionError(f"span epochs {[s['epoch'] for s in spans]}")
    if set(scrape["stages"]) != stages:
        raise AssertionError(f"span stages {sorted(scrape['stages'])} != "
                             f"{sorted(stages)}")
    for name, st in scrape["stages"].items():
        print(f"    {name:16s} {st['seconds']:10.6f} s  "
              f"{100 * st['share']:6.2f} %")
    pump = scrape["stages"]["pump"]["seconds"]
    covered = scrape["span_total_s"] + pump
    print(f"  per batch (s): "
          f"{[round(s['total_s'] + s['stages']['pump'], 4) for s in spans]}"
          f"; the spans and their pumps cover {covered:.4f} s of the "
          f"stream's {res['stream_time']:.4f} s, the rest "
          f"{res['stream_time'] - covered:.4f} s (idle polls, the drain "
          f"wait, close)")


def _shm_leftovers() -> list[str]:
    prefix = f"reprotorchshm_{os.getpid()}_"
    return [f for f in os.listdir("/dev/shm") if f.startswith(prefix)]


def remote_phase(torch, dev, smi: str) -> None:
    """The remote ingest at the §III frame shape, over TCP and over a Unix
    socket: a spawned detector process on the host, the consumer's
    reduction on the card, held to numpy over the same frames."""
    import tempfile

    import numpy as np

    from repro_torch.apps.ptycho.remote_ingest import (parse_args,
                                                       run_remote_ingest)
    from repro_torch.apps.ptycho.sim import simulate

    # the producer's frames: the same scan simulated on the host
    base = parse_args(REMOTE_ARGS)
    problem = simulate(base.obj_size, base.probe_size,
                       step=max(8, base.probe_size // 4), device="cpu")
    mags = problem.magnitudes_host[:REMOTE_FRAMES].astype(np.float64)
    want = {"photons": float((mags ** 2).sum()), "peak": float(mags.max())}
    print(f"  scan: {problem.num_frames} positions of {problem.frame_shape}"
          f" fp32; {REMOTE_FRAMES} frames, "
          f"{mags.size * 4 / 2**20:.1f} MiB, cross the socket", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for family, addr in (("tcp", "127.0.0.1:0"),
                             ("unix", os.path.join(tmp, "broker.sock"))):
            args = parse_args(REMOTE_ARGS + ["--addr", addr])
            res = run_remote_ingest(args, device=dev)
            prod, served, rt = res["producer"], res["server"], res["realtime"]
            errs = {k: abs(res[k] - v) / abs(v) for k, v in want.items()}
            leftovers = _shm_leftovers()
            print(f"  {family} {res['address']}: {res['frames']} of "
                  f"{res['appended']} frames consumed, the last after "
                  f"{res['consume_s']:.4f} s: "
                  f"{res['frames'] / res['consume_s']:.1f} frames/s "
                  f"({res['wall_s']:.4f} s to the producer's exit); "
                  f"{prod['produce_calls']} produce calls, "
                  f"{prod['produced'] / prod['produce_calls']:.1f} frames a "
                  f"round trip, {prod['shm_frames_sent']} on shm frames; "
                  f"blocked {prod['blocked_s']:.4f} s, max lag "
                  f"{prod['max_observed_lag']} (bound "
                  f"{args.max_pending + 16}); {rt['batches']} batches, mean "
                  f"processing {rt['mean_processing_s'] * 1e3:.3f} ms, max "
                  f"{rt['max_processing_s'] * 1e3:.3f} ms, keeps_up "
                  f"{rt['keeps_up']} against {res['batch_interval']} s; "
                  f"server: {served['requests_served']} requests, "
                  f"{served['frames_rejected']} rejected, "
                  f"{served['shm_frames']} shm frames, "
                  f"{served['shm_segments']} segments left, /dev/shm "
                  f"{leftovers}; photons {res['photons']:.6e} (numpy "
                  f"{want['photons']:.6e}), peak {res['peak']:.6f} (numpy "
                  f"{want['peak']:.6f}), rel. diff "
                  f"{max(errs.values()):.3g}", flush=True)
            if not (res["frames"] == res["appended"] == REMOTE_FRAMES
                    and res["frame_ids"] == list(range(REMOTE_FRAMES))):
                raise AssertionError(f"{family}: consumed {res['frames']} "
                                     f"of {res['appended']} appended")
            if served["frames_rejected"]:
                raise AssertionError(f"{family}: frames rejected {served}")
            if not (prod["shm_frames_sent"] == prod["produce_calls"]
                    == served["shm_frames"] > 0):
                raise AssertionError(f"{family}: not every produce rode an "
                                     f"shm frame: {prod}, {served}")
            if prod["max_observed_lag"] > args.max_pending + 16:
                raise AssertionError(f"{family}: lag {prod} over its bound")
            if not max(errs.values()) <= REMOTE_RTOL:
                raise AssertionError(f"{family}: card {res['photons']}, "
                                     f"{res['peak']} vs numpy {want}")
            if served["shm_segments"] or leftovers:
                raise AssertionError(f"{family}: shm left: {served}, "
                                     f"{leftovers}")
    print(f"  remote ingest OK on {smi}", flush=True)


def _csr_bound_ms(csr, nslice: int, iters: int) -> tuple[float, str]:
    """The bytes and operations these inputs need: the CSR's columns, values
    and row pointers (again every sweep once larger than the L2), b,
    inv_rip, f in and out; a dot and an axpy, 4 operations a non-zero, a
    slice and a sweep."""
    nrow, ncol = csr.shape
    nnz = csr.col.numel()
    csr_bytes = 8 * nnz + 8 * (nrow + 1)
    reads = iters if csr_bytes > L2_BYTES else 1
    return _bound_ms(reads * csr_bytes + 4 * (nslice * nrow + nrow
                                              + 2 * nslice * ncol),
                     4 * nnz * nslice * iters)


def _dense_bound_ms(nrow: int, ncol: int, nslice: int,
                    iters: int) -> tuple[float, str]:
    """The dense sweep's bound: A read once a sweep when it
    exceeds the L2, every element of it a dot and an axpy."""
    a_reads = iters if 4 * nrow * ncol > L2_BYTES else 1
    return _bound_ms(4 * (a_reads * nrow * ncol + nslice * nrow + nrow
                          + 2 * nslice * ncol),
                     4 * nrow * ncol * nslice * iters)


def art_phase(torch, dev, flush) -> dict:
    """The ART kernel over the system's non-zeros (CSR) against the plain
    dense version in float32 (held to ART_TOL) and in float64 (reported),
    timed beside its bound and the dense sweep's."""
    import numpy as np

    from repro_torch.apps.tomo.projector import make_system, project
    from repro_torch.apps.tomo.solver import make_phantom
    from repro_torch.kernels.art import kernel as ak
    from repro_torch.kernels.art import ops as ao
    from repro_torch.kernels.art import ref as ar

    def measure(label, A, b, f0, iters, reps, csr=None):
        nrow, ncol = A.shape
        nslice = b.shape[0]
        inv_rip = ao.inverse_row_norms(A)
        if csr is None:
            csr = ao.csr_rows(A)

        def call():
            return ak.art_sweep(csr, b, inv_rip, f0, 1.0, iters)

        def plain():
            return ar.art_sweep_ref(A, b, inv_rip, f0, 1.0, iters)

        want = plain()
        want64 = ar.art_sweep_ref(A.double(), b.double(), inv_rip.double(),
                                  f0.double(), 1.0, iters)
        got = call()
        torch.cuda.synchronize()
        err = _max_err(torch, got, want)
        torch.testing.assert_close(got, want, **ART_TOL)
        err64 = _max_err(torch, got.double(), want64)
        plain64 = _max_err(torch, want.double(), want64)
        del want64
        print(f"  art_sweep {label}: max|kernel - plain| {err:.3g} (tol "
              f"1e-4 + 1e-4 relative); against float64: "
              f"kernel {err64:.3g}, plain {plain64:.3g}; max|f| "
              f"{float(want.abs().max()):.3g}", flush=True)
        ms = _time_ms(torch, call, reps=reps, warmup=1, flush=flush)
        plain_ms = _time_ms(torch, plain, reps=3, warmup=1, flush=flush)
        bound, by = _csr_bound_ms(csr, nslice, iters)
        dense, dense_by = _dense_bound_ms(nrow, ncol, nslice, iters)
        print(f"    kernel {ms:.4f} ms ({ms * 1e3 / (nrow * iters):.3f} us a "
              f"row step); plain {plain_ms:.4f} ms; bound {bound:.4g} ms ({by}, the "
              f"{csr.col.numel()} non-zeros), dense bound {dense:.4g} ms "
              f"({dense_by}); library n/a", flush=True)
        return {"name": f"art_sweep ({label})", "route": "cuda",
                "source": "src/repro_torch/csrc/art.cu",
                "replaces": "src/repro/kernels/art/kernel.py:43",
                "max_abs_err": err, "err_vs_float64": err64,
                "plain_err_vs_float64": plain64, "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "dense_bound_ms": dense,
                "library_ms": None}

    rng = np.random.default_rng(SEED)
    variants = []
    for nrow, ncol in ART_SHAPES + (ART_ODD_SHAPE, ART_LONG_SHAPE):
        for iters in (1, 3):
            A = rng.standard_normal((nrow, ncol)).astype(np.float32)
            f_true = rng.standard_normal((3, ncol)).astype(np.float32)
            A_t = torch.from_numpy(A).to(dev)
            b = torch.from_numpy(f_true @ A.T).to(dev)
            f0 = torch.zeros((3, ncol), device=dev)
            variants.append(measure(
                f"{nrow}x{ncol}, 3 slices, {iters} "
                f"sweep{'s' if iters > 1 else ''}", A_t, b, f0, iters, 25))

    angles = np.linspace(-75, 75, NANGLES)
    t0 = time.perf_counter()
    A_host = make_system(NRAY, angles)
    t1 = time.perf_counter()
    A = torch.from_numpy(A_host).to(dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    csr = ao.csr_rows(A)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    nnz = csr.row_ptr[1:] - csr.row_ptr[:-1]
    print(f"  system matrix {tuple(A.shape)} fp32 "
          f"({A.numel() * 4 / 2**30:.2f} GiB): host build {t1 - t0:.2f} s, "
          f"copy to the card {t2 - t1:.2f} s, CSR on the card "
          f"{t3 - t2:.3f} s ({csr.col.numel()} non-zeros, "
          f"{8 * csr.col.numel() / 1e6:.1f} MB of columns and values); "
          f"non-zeros a row: mean {float(nnz.double().mean()):.1f}, min "
          f"{int(nnz.min())}, max {int(nnz.max())} of {A.shape[1]}",
          flush=True)
    del nnz
    vol = torch.from_numpy(make_phantom(NSLICE, NRAY, SEED)).to(dev)
    for lo, nslice, iters in ((124, 8, 1), (120, 16, 2)):
        b = project(A, vol[lo:lo + nslice]).contiguous()
        f0 = torch.zeros((nslice, NRAY * NRAY), device=dev)
        variants.append(measure(
            f"{A.shape[0]}x{A.shape[1]}, slices {lo}-{lo + nslice - 1}, "
            f"{iters} sweep{'s' if iters > 1 else ''}", A, b, f0, iters, 5,
            csr))
    # one warp a slice: how a launch's time grows with its slices
    inv_rip = ao.inverse_row_norms(A)
    for nslice in (16, 128, 256):
        b = project(A, vol[:nslice]).contiguous()
        f0 = torch.zeros((nslice, NRAY * NRAY), device=dev)
        ms = _time_ms(torch, lambda: ak.art_sweep(csr, b, inv_rip, f0, 1.0,
                                                  1), reps=3, warmup=1)
        print(f"  occupancy: {nslice} slices, one sweep: {ms:.3f} ms, "
              f"{ms * 1e3 / A.shape[0]:.3f} us a row step, "
              f"{ms / nslice:.4f} ms a slice", flush=True)
    # the row of a stream launch: 16 slices, two sweeps
    return dict(variants[-1], name="art_sweep",
                max_abs_err=max(v["max_abs_err"] for v in variants),
                variants=variants)


def tomo_phase(torch, dev, kernel_ms: float) -> tuple[int, "np.ndarray"]:
    """The §IV stream at full width; returns the ART launches it made and
    the gathered volume."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.apps.tomo.solver import clear_system_cache
    from repro_torch.apps.tomo.stream import parse_args, run_stream

    clear_system_cache()            # a cold start: build and copy anew
    torch.cuda.empty_cache()
    out = OUT / "tomo"
    shutil.rmtree(out, ignore_errors=True)
    args = parse_args(TOMO_ARGS + ["--out", str(out), "--obs-port", "0"])
    kernels.reset_launch_counts()
    res = run_stream(args, device=dev)
    counts = kernels.launch_counts()
    launches = counts["art_sweep"]
    print(f"  partitions processed {res['partitions']}, launches {counts}")
    if not launches == res["partitions"] == res["launches"] > 0:
        raise AssertionError(f"ART launches {launches} (run_stream reports "
                             f"{res['launches']}) != partitions processed "
                             f"{res['partitions']}, or none")
    if any(n for name, n in counts.items() if name != "art_sweep"):
        raise AssertionError(f"other kernels launched: {counts}")
    if not np.isfinite(res["volume"]).all():
        raise AssertionError("non-finite values in the gathered volume")
    if res["volume"].shape != (NSLICE, NRAY, NRAY):
        raise AssertionError(f"volume shape {res['volume'].shape}")
    got = {"residual": (res["residual"], REF_RESIDUAL),
           "error": (res["error"], REF_ERROR)}
    for i, s in enumerate(REF_SLICES):
        got[f"slice {s} residual"] = (float(res["slice_residuals"][s]),
                                      REF_SLICE_RESIDUAL[i])
        got[f"slice {s} error"] = (float(res["slice_errors"][s]),
                                   REF_SLICE_ERROR[i])
    worst = max(abs(a - b) for a, b in got.values())
    print(f"  residual {res['residual']:.6f} (JAX {REF_RESIDUAL:.6f}), "
          f"volume error {res['error']:.6f} (JAX {REF_ERROR:.6f}); slices "
          f"{REF_SLICES.start}-{REF_SLICES.stop - 1} residuals "
          f"{[round(float(res['slice_residuals'][s]), 6) for s in REF_SLICES]}"
          f", errors "
          f"{[round(float(res['slice_errors'][s]), 6) for s in REF_SLICES]}; "
          f"max |port - JAX| {worst:.3g} (tol {REF_TOL})")
    bad = {k: v for k, v in got.items() if not abs(v[0] - v[1]) <= REF_TOL}
    if bad:
        raise AssertionError(f"off the JAX reference by more than {REF_TOL}:"
                             f" {bad}")
    # batches of NSLICE / PARTITIONS slices, each cut into PARTITIONS
    per = NSLICE // PARTITIONS // PARTITIONS
    want_keys = [f"slices-{i:04d}-{i + per - 1:04d}"
                 for i in range(0, NSLICE, per)]
    if res["sink_keys"] != want_keys:
        raise AssertionError(f"sink holds {res['sink_keys']}, expected "
                             f"{want_keys}")
    obs_report(res, len(res["batch_times"]), NSLICE, STREAM_STAGES)
    in_batches = sum(res["batch_times"])
    print(f"  set-up {res['setup_time']:.3f} s: system matrix host build "
          f"{res['matrix_build_time']:.3f} s, copy to the card with its "
          f"row norms and CSR {res['matrix_copy_time']:.3f} s")
    print(f"  stream OK: {len(res['batch_times'])} batches, batch times (s) "
          f"{[round(t, 4) for t in res['batch_times']]}, stream "
          f"{res['stream_time']:.3f} s ({in_batches:.3f} s in batches), "
          f"{NSLICE / res['stream_time']:.2f} slices/s; {launches} launches "
          f"x {kernel_ms:.1f} ms (phase 7, stream-launch shape) = "
          f"{launches * kernel_ms / 1e3 / res['stream_time']:.3f} of the "
          f"stream's wall time; {len(res['sink_keys'])} sink keys")
    return launches, res["volume"]


def tomo_profile_phase(torch, dev) -> None:
    """Device time and idle share of one §IV batch (NSLICE / PARTITIONS
    slices in PARTITIONS RDD partitions) through the stream's own partition
    function, with the system already on the card."""
    import functools

    import numpy as np
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import kernels
    from repro_torch.apps.tomo.solver import TomoConfig, simulate_tilt_series
    from repro_torch.apps.tomo.stream import reconstruct_partition
    from repro_torch.core.rdd import Context

    cfg = TomoConfig(nray=NRAY, iterations=2, angles=tuple(
        np.linspace(-75, 75, NANGLES).tolist()))      # as run_stream's
    nslice = NSLICE // PARTITIONS
    _, _, sino = simulate_tilt_series(cfg, nslice, seed=SEED, device=dev)
    records = list(enumerate(sino))
    part = functools.partial(reconstruct_partition, config=cfg, device=dev)

    def batch():
        Context().parallelize(records, PARTITIONS).map_partitions(
            part).collect_partitions()      # each partition ends on the host

    t0 = time.perf_counter()                # wall time without the profiler
    batch()
    wall_ms = (time.perf_counter() - t0) * 1e3
    for attempt in (1, 2):
        # the trace's first step can miss a launch: a warm-up step is traced
        # and dropped, the second batch is the one read
        # (active=2 and no second step: the window closes with the context,
        # which keeps its events)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=2)) as prof:
            batch()
            prof.step()
            before = kernels.launch_counts()["art_sweep"]
            batch()
            launched = kernels.launch_counts()["art_sweep"] - before
        seen = sum(1 for ev in prof.events() or ()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ART_KERNEL in ev.name)
        if seen == launched:
            break
        print(f"  profile {attempt}: the profiler saw {seen} of the "
              f"{launched} ART launches")
    else:
        print("  profile: launches missing from the trace; idle share not "
              "measured")
        return
    by_kernel = _device_us(torch, prof)
    busy_ms = sum(by_kernel.values()) / 1e3
    art_ms = sum(us for name, us in by_kernel.items()
                 if ART_KERNEL in name) / 1e3
    print(f"  one batch of {nslice} slices in {PARTITIONS} partitions: wall "
          f"{wall_ms:.3f} ms unprofiled; device busy {busy_ms:.3f} ms "
          f"(profiled, {seen} ART launches seen of {launched}), idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.4f}; the ART kernel "
          f"{art_ms:.3f} ms")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {us / 1e3:10.3f} ms {100 * us / 1e3 / busy_ms:5.1f}%  "
              f"{name[:90]}")


GROUP, GROUP_TOPIC, GROUP_PARTITIONS = "tomo", "slices", 4
GROUP_HEARTBEAT, GROUP_SESSION = 0.05, 0.4
GROUP_VOLUME_RTOL = 1e-6
GROUP_DEADLINE_S = 120.0


def group_phase(torch, dev, tomo_volume, smi: str) -> int:
    """The §IV slices through a consumer group of two streaming contexts in
    threads of one process, each batch's ranges reconstructed by the ART
    kernel: one consumer goes silent after its second committed batch (no
    leave, no heartbeat), the survivor takes its partitions over, and the
    silent one's late commit is fenced. The volume is held to phase 8's,
    slice by slice; returns the ART launches."""
    import functools
    import threading

    import numpy as np

    from repro_torch import kernels
    from repro_torch.apps.tomo.solver import (TomoConfig, residual,
                                              simulate_tilt_series)
    from repro_torch.apps.tomo.stream import reconstruct_partition
    from repro_torch.core.broker import Broker
    from repro_torch.core.dstream import StreamingContext
    from repro_torch.core.rdd import Context
    from repro_torch.data.groups import StaleGenerationError
    from repro_torch.data.sinks import KeyedSink

    cfg = TomoConfig(nray=NRAY, iterations=2, angles=tuple(
        np.linspace(-75, 75, NANGLES).tolist()))      # as run_stream's
    vol_true, sino, sino_host = simulate_tilt_series(cfg, NSLICE, device=dev)
    broker = Broker()
    broker.create_topic(GROUP_TOPIC, GROUP_PARTITIONS)
    broker.produce_many(GROUP_TOPIC, [(f"slice-{i:06d}".encode(),
                                       (i, sino_host[i]))
                                      for i in range(NSLICE)])
    per_part = broker.end_offsets(GROUP_TOPIC)

    class VolumeSink(KeyedSink):
        def __init__(self):
            super().__init__()
            self.rows = {}

        def _write_one(self, key, value):
            self.rows[key] = value

    sink = VolumeSink()
    part = functools.partial(reconstruct_partition, config=cfg, device=dev)

    def process(rdd, info):
        # one RDD partition a range: one ART launch a range
        parts = rdd.map_partitions(part).collect_partitions()
        sink.write_batch([(f"slice-{i:04d}", block[j])
                          for idx, block in parts
                          for j, i in enumerate(idx)])

    ctxs = []
    for cid in ("survivor", "victim"):
        sc = StreamingContext(Context(), broker,
                              max_records_per_partition=NSLICE
                              // PARTITIONS // PARTITIONS)
        sc.subscribe([GROUP_TOPIC])
        sc.foreach_batch(process)
        sc.join_group(GROUP, consumer_id=cid,
                      heartbeat_interval=GROUP_HEARTBEAT,
                      session_timeout=GROUP_SESSION)
        ctxs.append(sc)
    survivor, victim = ctxs
    survivor.group_member.maintain(force=True)    # the settled split first
    gen_split = broker.describe_group(GROUP)["generation"]
    split = {c: list(a.get(GROUP_TOPIC, [])) for c, a in
             broker.describe_group(GROUP)["assignments"].items()}
    silent = {"at": None, "member": None}
    errors = []
    deadline = time.perf_counter() + GROUP_DEADLINE_S

    def run(sc, is_victim):
        try:
            while broker.lag(GROUP_TOPIC, group=GROUP) > 0:
                if time.perf_counter() > deadline:
                    raise AssertionError(
                        f"group lag {broker.lag(GROUP_TOPIC, group=GROUP)} "
                        f"after {GROUP_DEADLINE_S} s; sink "
                        f"{len(sink.rows)} of {NSLICE} slices")
                if sc.run_one_batch() is None:
                    time.sleep(0.0005)
                elif is_victim and len(sc.history) == 2:
                    # silent from here: no leave, no heartbeat
                    silent["member"] = (sc.group_member.consumer_id,
                                        sc.group_member.generation,
                                        sc.history[-1].ranges[0])
                    silent["at"] = time.perf_counter()
                    return
        except BaseException as e:                  # re-raised below
            errors.append(e)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(sc, sc is victim))
               for sc in ctxs]
    for th in threads:
        th.start()
    gap = None
    while any(th.is_alive() for th in threads):
        if gap is None and silent["at"] is not None and sum(
                len(ps) for ps in
                survivor.group_member.assignment.values()) == \
                GROUP_PARTITIONS:
            gap = time.perf_counter() - silent["at"]
        time.sleep(0.001)
    for th in threads:
        th.join()
    stream_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    if errors:
        raise errors[0]
    if silent["at"] is None:
        raise AssertionError("the victim never committed two batches")
    if gap is None:     # the handoff landed between the last two polls
        gap = float("nan")
    ranges_run = sum(len(b.ranges) for sc in ctxs for b in sc.history)
    owned = sorted(p for ps in survivor.group_member.assignment.values()
                   for p in ps)
    d = broker.describe_group(GROUP)
    # the victim wakes once and commits what it had consumed
    vid, vgen, vrange = silent["member"]
    try:
        broker.commit(vrange.topic, vrange.partition, vrange.until,
                      group=GROUP, consumer=vid, generation=vgen)
        fenced = None
    except StaleGenerationError as e:
        fenced = str(e)
    lag = broker.lag(GROUP_TOPIC, group=GROUP)
    victim.group_member = None          # it died: no leave on close
    victim.close()
    survivor.close()

    recon = np.zeros((NSLICE, NRAY, NRAY), np.float32)
    for key, row in sink.rows.items():
        recon[int(key.split("-")[1])] = row
    rec = torch.from_numpy(recon).to(dev)
    res = residual(rec, sino, cfg)
    err = float(torch.linalg.vector_norm(rec - vol_true)
                / torch.linalg.vector_norm(vol_true))
    diff = np.linalg.norm((recon - tomo_volume).reshape(NSLICE, -1), axis=1)
    ref = np.linalg.norm(tomo_volume.reshape(NSLICE, -1), axis=1)
    rel = diff / np.maximum(ref, 1e-30)
    print(f"  {GROUP_TOPIC}: {NSLICE} slices keyed by slice index on "
          f"{GROUP_PARTITIONS} partitions {per_part}; split at generation "
          f"{gen_split} {split}; the victim silent after its 2nd batch "
          f"(generation {vgen}); the survivor owned {owned} at generation "
          f"{d['generation']} after {gap:.4f} s (session timeout "
          f"{GROUP_SESSION} s, heartbeat {GROUP_HEARTBEAT} s); batches: "
          f"survivor {len(survivor.history)}, victim {len(victim.history)}; "
          f"{ranges_run} ranges, launches {counts}; stream "
          f"{stream_s:.3f} s; sink {len(sink.rows)} slices, "
          f"{sink.skipped} processed twice; group lag {lag}; the victim's "
          f"late commit: {fenced}", flush=True)
    print(f"  group handoff OK on {smi}: residual {res:.6f} (JAX "
          f"{REF_RESIDUAL:.6f}), volume error {err:.6f} (JAX "
          f"{REF_ERROR:.6f}); max relative difference to phase 8's volume, "
          f"slice by slice, {rel.max():.3g} (tol {GROUP_VOLUME_RTOL}), "
          f"{int((diff == 0).sum())} of {NSLICE} slices bit-equal",
          flush=True)
    if len(sink.rows) != NSLICE:
        raise AssertionError(f"sink holds {len(sink.rows)} of {NSLICE}")
    if owned != list(range(GROUP_PARTITIONS)) or list(d["members"]) != \
            ["survivor"]:
        raise AssertionError(f"survivor owns {owned}; group {d}")
    if fenced is None:
        raise AssertionError("the victim's late commit was not fenced")
    if lag != 0:
        raise AssertionError(f"group lag {lag}")
    if not rel.max() <= GROUP_VOLUME_RTOL:
        raise AssertionError(f"volume off phase 8's by {rel.max()}")
    if not (abs(res - REF_RESIDUAL) <= REF_TOL
            and abs(err - REF_ERROR) <= REF_TOL):
        raise AssertionError(f"residual {res}, error {err} off the JAX "
                             f"reference by more than {REF_TOL}")
    launches = counts["art_sweep"]
    if not launches == ranges_run > 0 or any(
            n for name, n in counts.items() if name != "art_sweep"):
        raise AssertionError(f"launches {counts} for {ranges_run} ranges")
    return launches


def build_report(kernels: tuple[str, ...]) -> None:
    """ptxas's registers, shared memory and spills of ``kernels`` (from the
    build's log), and the tensor-core instructions in the SASS of the two
    flash kernels that use them (cuobjdump, next to nvcc): HGMMA in the
    wgmma kernel, TF32 HMMA in the tf32x3 one; raises if either has none."""
    import re

    from repro_torch.kernels import _build

    log = _build.BUILD_DIR / _build.LOG_NAME
    entry = None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = next((k for k in kernels if k in m.group(1)), None)
            if entry:
                print(f"  ptxas {entry} ({m.group(1)[:60]}):")
        elif entry and ("Used" in line or "spill" in line):
            print(f"    {line.split('ptxas info    :')[-1].strip()}")
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        print(f"  cuobjdump not found next to nvcc ({cuobjdump}): the HGMMA "
              f"and HMMA counts are not measured")
        return
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(_build.BUILD_DIR / _build.LIB_NAME)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
        elif fn and "HGMMA" in line:
            counts[fn, "HGMMA"] = counts.get((fn, "HGMMA"), 0) + 1
        elif fn and "HMMA" in line and "TF32" in line:
            counts[fn, "HMMA"] = counts.get((fn, "HMMA"), 0) + 1
    for kernel, op, what in (
            ("flash_attention_wgmma", "HGMMA", "HGMMA"),
            ("flash_attention_tf32x3", "HMMA", "TF32 HMMA")):
        n = sum(c for (f, o), c in counts.items() if kernel in f and o == op)
        total = sum(c for (_, o), c in counts.items() if o == op)
        print(f"  {what} instructions in {kernel}_kernel's SASS: {n} (all "
              f"functions: {total})")
        if n == 0:
            raise AssertionError(f"no {what} in {kernel}_kernel's SASS")


def sdpa_kernels(torch, dev) -> dict[str, str]:
    """The device kernels of ``scaled_dot_product_attention`` at the model
    shape, by dtype, by the profiler, with each one's time a call. Taken
    before any other trace in the process: a short trace after earlier
    ones came back empty on the card."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    names, calls = {}, 3
    for dtype in ("bfloat16", "float32"):
        q, k, v = (torch.randn(MODEL_B, MODEL_H, MODEL_S, MODEL_HD,
                               device=dev, dtype=getattr(torch, dtype))
                   for _ in range(3))
        F.scaled_dot_product_attention(q, k, v, is_causal=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                F.scaled_dot_product_attention(q, k, v, is_causal=True)
            torch.cuda.synchronize()
        seen = sorted(_device_us(torch, prof).items(), key=lambda kv: -kv[1])
        names[dtype] = "; ".join(f"{name} ({us / calls:.1f} us a call)"
                                 for name, us in seen) or "none seen"
        print(f"  SDPA's kernels in {dtype} at B {MODEL_B}, S {MODEL_S}, H "
              f"{MODEL_H}, hd {MODEL_HD} (profiler): {names[dtype]}",
              flush=True)
    return names


def flash_phase(torch, dev, flush) -> tuple[dict, dict, dict]:
    """The three flash kernels against their plain version (held to
    FLASH_TOL): at the test shapes (fp32 on the tf32x3 kernel, bf16 on the
    SIMT one); at hd 128 the wgmma kernel (bf16) and the tf32x3 kernel
    (fp32) at S 64 and 130 (one tile, a ragged last one), 1,000 through
    ``ops`` and the model's prefill. At the model shape each is timed
    beside its bound and PyTorch's ``scaled_dot_product_attention`` (timed
    for the table only), the tf32x3 kernel also beside the fp32-FMA bound;
    the SIMT kernel is timed at the model's batch and sequence in bf16 at
    hd 32. Returns the wgmma, tf32x3 and SIMT rows."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.kernels.flash_attention import ref as fr

    build_report(("flash_attention_wgmma_kernel",
                  "flash_attention_tf32x3_kernel", "art_csr_kernel"))
    rng = np.random.default_rng(SEED)

    def qkv(shape, dtype):
        return [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, getattr(torch, dtype)) for _ in range(3)]

    def check(label, dtype, got, want):
        torch.cuda.synchronize()
        err = _max_err(torch, got.float(), want.float())
        tol = FLASH_TOL[dtype]
        print(f"  flash_attention {label}, {dtype}: max|kernel - plain| "
              f"{err:.3g} (tol {tol} + {tol} relative)", flush=True)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        return {"name": f"flash_attention ({label}, {dtype})",
                "max_abs_err": err}

    def designed(design, fn):
        """Run ``fn``, asserting that its one launch went to ``design``."""
        before = dict(fk.flash_attention.launches_by_design)
        out = fn()
        after = fk.flash_attention.launches_by_design
        if {d: after[d] - before[d] for d in after} != {
                d: int(d == design) for d in after}:
            raise AssertionError(f"expected one {design} launch: {before} -> "
                                 f"{after}")
        return out

    variants = {d: [] for d in fk.DESIGNS}
    for S, hd in FLASH_SHAPES:
        for dtype in FLASH_TOL:
            design = fk.design_for(getattr(torch, dtype), hd)
            q, k, v = qkv((4, S, hd), dtype)
            got = designed(design, lambda: fk.flash_attention(
                q[:, :, None], k[:, :, None], v[:, :, None])[:, :, 0])
            variants[design].append(check(f"{design}, BH 4, S {S}, hd {hd}",
                                          dtype, got,
                                          fr.attention_ref(q, k, v)))
    for B, S, H in ((2, 64, 4), (2, 130, 4)):
        for dtype in FLASH_TOL:
            design = fk.design_for(getattr(torch, dtype), MODEL_HD)
            q, k, v = qkv((B, S, H, MODEL_HD), dtype)
            got = designed(design, lambda: fk.flash_attention(q, k, v))
            variants[design].append(check(
                f"{design}, B {B}, S {S}, H {H}, hd {MODEL_HD}", dtype, got,
                fo.flash_attention(q, k, v, use_kernel=False)))
    for dtype in FLASH_TOL:         # the tail: 1,000 = 7 x 128 + 104
        design = fk.design_for(getattr(torch, dtype), MODEL_HD)
        q, k, v = qkv((1, 1000, MODEL_H, MODEL_HD), dtype)
        got = designed(design, lambda: fo.flash_attention(q, k, v))
        variants[design].append(check(
            f"{design} through ops, B 1, S 1000, H {MODEL_H}, hd {MODEL_HD}",
            dtype, got, fo.flash_attention(q, k, v, use_kernel=False)))
    rows = {}
    # the SIMT kernel's largest head dim at the model's batch and sequence
    timed = (("bfloat16", MODEL_HD), ("float32", MODEL_HD),
             ("bfloat16", max(hd for _, hd in FLASH_SHAPES)))
    for dtype, hd in timed:
        design = fk.design_for(getattr(torch, dtype), hd)
        shape = (MODEL_B, MODEL_S, MODEL_H, hd)
        q, k, v = qkv(shape, dtype)

        def call():
            return fk.flash_attention(q, k, v)

        def plain():
            return fo.flash_attention(q, k, v, use_kernel=False)

        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        got = designed(design, call)
        row = check(f"{design}, B {MODEL_B}, S {MODEL_S}, H {MODEL_H}, hd "
                    f"{hd}", dtype, got, plain())
        sdpa_err = _max_err(torch, got.float(),
                            library().transpose(1, 2).float())
        ms = _time_ms(torch, call, flush=flush)
        plain_ms = _time_ms(torch, plain, flush=flush)
        library_ms = _time_ms(torch, library, flush=flush)
        # q, k, v read once and o written once; QK^T and PV over the causal
        # half, 2 operations a multiply-add, at the card's rate for the
        # type: bf16 on the tensor cores, fp32 as three TF32 products on
        # them (the tf32x3 kernel's work), the fp32 FMA rate beside it
        bh, elem = MODEL_B * MODEL_H, q.element_size()
        nbytes = 4 * bh * MODEL_S * hd * elem
        ops = 2 * 2 * bh * (MODEL_S * (MODEL_S + 1) / 2) * hd
        if dtype == "bfloat16":
            bound, by = _bound_ms(nbytes, ops, BF16_TC_OPS_PER_S)
            extra = ""
        else:
            bound, by = _bound_ms(nbytes, 3 * ops, TF32_TC_OPS_PER_S)
            fma_ms, fma_by = _bound_ms(nbytes, ops, FP32_OPS_PER_S)
            row.update(bound_fp32_fma_ms=fma_ms)
            extra = (f" (3 x {ops / 1e9:.2f} GFLOP of TF32 at "
                     f"{TF32_TC_OPS_PER_S / 1e12:.0f} TFLOP/s; fp32 FMA bound "
                     f"{fma_ms:.4f} ms ({fma_by}))")
        print(f"    {design} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({by}){extra}, library (SDPA) "
              f"{library_ms:.4f} ms; max|kernel - SDPA| {sdpa_err:.3g} "
              f"(reported)", flush=True)
        row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   library_ms=library_ms, max_abs_err_vs_library=sdpa_err)
        variants[design].append(row)
        rows[design] = row
    sources = {"wgmma": "src/repro_torch/csrc/flash_attention_wgmma.cu",
               "tf32x3": "src/repro_torch/csrc/flash_attention_tf32x3.cu",
               "simt": "src/repro_torch/csrc/flash_attention.cu"}
    names = {"wgmma": "wgmma, bf16 hd 128", "tf32x3": "tf32x3, fp32",
             "simt": "simt, bf16 hd 8/16/32 only"}
    replaces = "src/repro/kernels/flash_attention/kernel.py:79"
    return tuple(dict(rows[d], name=f"flash_attention ({names[d]})",
                      route="cuda", source=sources[d], replaces=replaces,
                      launches=0,
                      max_abs_err=max(v["max_abs_err"] for v in variants[d]),
                      variants=variants[d])
                 for d in ("wgmma", "tf32x3", "simt"))


def _param_count(params) -> int:
    if isinstance(params, dict):
        return sum(_param_count(v) for v in params.values())
    if isinstance(params, list):
        return sum(_param_count(v) for v in params)
    return params.numel()


def model_phase(torch, dev) -> int:
    """internlm2-1.8b at full width: the prefill with the kernel against
    the naive attention (bf16, every launch on the wgmma kernel), then the
    serve invariant in fp32 (on the tf32x3 kernel). Returns the tf32x3
    kernel's launches in the invariant's run."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import transformer

    config = get_config(ARCH)
    t0 = time.perf_counter()
    params = transformer.init(torch.Generator(device=dev).manual_seed(SEED),
                              config)
    torch.cuda.synchronize()
    n = _param_count(params)
    print(f"  {ARCH}: {config.num_layers} layers, d_model {config.d_model}, "
          f"{config.num_heads}/{config.num_kv_heads} heads of "
          f"{config.resolved_head_dim}, d_ff {config.d_ff}, vocab "
          f"{config.vocab_size}: {n / 1e9:.3f} B parameters, "
          f"{n * 2 / 1e9:.2f} GB in bf16, drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, config.vocab_size, (MODEL_B, MODEL_S))).to(dev)
    naive = config.replace(attention_impl="naive")
    with torch.inference_mode():
        kernels.reset_launch_counts()
        lk, _ = transformer.prefill(params, {"tokens": tokens}, config)
        launched = kernels.launch_counts()["flash_attention"]
        by_design = dict(fk.flash_attention.launches_by_design)
        ln, _ = transformer.prefill(params, {"tokens": tokens}, naive)
        ms_k = _time_ms(torch, lambda: transformer.prefill(
            params, {"tokens": tokens}, config), reps=3, warmup=1)
        ms_n = _time_ms(torch, lambda: transformer.prefill(
            params, {"tokens": tokens}, naive), reps=3, warmup=1)
    if not (torch.isfinite(lk).all() and torch.isfinite(ln).all()):
        raise AssertionError("non-finite prefill logits")
    if lk.shape != (MODEL_B, 1, config.vocab_size):
        raise AssertionError(f"logits shape {tuple(lk.shape)}")
    diff = _max_err(torch, lk.float(), ln.float())
    agree = int((lk.argmax(-1) == ln.argmax(-1)).sum())
    print(f"  bf16 prefill of {MODEL_B} x {MODEL_S} tokens: kernel "
          f"({launched} launches, {by_design}) against naive attention: "
          f"last-token "
          f"logits max|diff| {diff:.4g} (limit {MAX_PREFILL_LOGIT_DIFF}; "
          f"max|logit| {float(ln.float().abs().max()):.3g}), greedy tokens "
          f"agree {agree}/{MODEL_B}; prefill {ms_k:.2f} ms with the kernel, "
          f"{ms_n:.2f} ms naive", flush=True)
    if by_design != {"wgmma": config.num_layers, "tf32x3": 0, "simt": 0}:
        raise AssertionError(f"flash launches {by_design} in a bf16 prefill "
                             f"of {config.num_layers} layers")
    if not diff <= MAX_PREFILL_LOGIT_DIFF:
        raise AssertionError(f"kernel and naive prefill logits differ by "
                             f"{diff} > {MAX_PREFILL_LOGIT_DIFF}")
    del params, lk, ln
    torch.cuda.empty_cache()

    # the serve invariant of tests/test_models.py:45-84, in full fp32
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("fp32 products would run in TF32")
    config = config.replace(dtype="float32", param_dtype="float32")
    params = transformer.init(torch.Generator(device=dev).manual_seed(SEED),
                              config)
    B, S, G = 2, 256, 4
    tokens = torch.from_numpy(rng.integers(0, config.vocab_size,
                                           (B, S))).to(dev)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        logits, cache = transformer.prefill(params, {"tokens": tokens},
                                            config, max_len=S + G)
        serve = [logits[:, -1].argmax(-1)]
        for _ in range(G - 1):
            logits, cache = transformer.decode_step(
                params, serve[-1][:, None], cache, config)
            serve.append(logits[:, -1].argmax(-1))
        full = tokens
        for g in range(G):
            logits2, _ = transformer.prefill(params, {"tokens": full}, config,
                                             max_len=full.shape[1] + 1)
            nxt = logits2[:, -1].argmax(-1)
            if not torch.equal(nxt, serve[g]):
                raise AssertionError(f"serve invariant broken at step {g}: "
                                     f"{nxt.tolist()} != {serve[g].tolist()}")
            full = torch.cat([full, nxt[:, None]], dim=1)
    by_design = dict(fk.flash_attention.launches_by_design)
    print(f"  fp32 serve invariant at full width (B {B}, S {S}, {G} tokens, "
          f"the kernel on, launches {by_design}): greedy prefill + decode == "
          f"teacher-forced prefills, tokens {torch.stack(serve, 1).tolist()}",
          flush=True)
    want = {"wgmma": 0, "tf32x3": (1 + G) * config.num_layers, "simt": 0}
    if by_design != want:
        raise AssertionError(f"flash launches {by_design} in {1 + G} fp32 "
                             f"prefills of {config.num_layers} layers, "
                             f"expected {want}")
    del params, cache
    torch.cuda.empty_cache()
    return by_design["tf32x3"]


def _greedy(torch, params, config, prompts, gen: int):
    """Greedy prefill + ``gen - 1`` decode steps: the tokens (B, gen) on the
    host, and each token's logits (B, V) in fp32."""
    from repro_torch.models import transformer

    with torch.inference_mode():
        logits, cache = transformer.prefill(
            params, {"tokens": prompts}, config,
            max_len=prompts.shape[1] + gen)
        steps = [logits[:, -1].float()]
        for _ in range(gen - 1):
            tok = steps[-1].argmax(-1, keepdim=True)
            logits, cache = transformer.decode_step(params, tok, cache,
                                                    config)
            steps.append(logits[:, -1].float())
    return torch.stack([s.argmax(-1) for s in steps], 1).cpu(), steps


def serve_phase(torch, dev) -> dict:
    """The serve stream at full width; returns its flash launches by
    design, every one of them on the wgmma kernel."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.serve import parse_args, run_serve

    args = parse_args(SERVE_ARGS)
    kernels.reset_launch_counts()
    res = run_serve(args, device=dev)
    counts = kernels.launch_counts()
    by_design = dict(fk.flash_attention.launches_by_design)
    n_layers = res["config"].num_layers
    batches = -(-args.requests // args.batch)
    want = batches * n_layers
    print(f"  launches {counts} (run_serve reports {res['launches']}), by "
          f"design {by_design}; expected flash_attention {batches} batches x "
          f"{n_layers} layers = {want}, all wgmma")
    if counts["flash_attention"] != want or res["launches"] != counts:
        raise AssertionError(f"flash launches {counts['flash_attention']} "
                             f"!= {want}")
    if by_design != {"wgmma": want, "tf32x3": 0, "simt": 0}:
        raise AssertionError(f"flash launches by design {by_design}, not "
                             f"all {want} on the wgmma kernel")
    if any(n for name, n in counts.items() if name != "flash_attention"):
        raise AssertionError(f"other kernels launched: {counts}")
    results = res["results"]
    vocab = res["config"].vocab_size
    if sorted(results) != list(range(args.requests)) or any(
            len(t) != args.gen or not all(0 <= x < vocab for x in t)
            for t in results.values()):
        raise AssertionError(f"results {results}")
    print(f"  served {len(results)} requests x {args.gen} tokens "
          f"({res['tokens']} tokens) in {res['stream_s']:.3f} s: "
          f"{res['tokens_per_s']:.1f} tokens/s")
    print(f"  per batch: prefill (s) {[round(x, 4) for x in res['prefill_s']]}"
          f", decode of {args.gen - 1} steps (s) "
          f"{[round(x, 4) for x in res['decode_s']]}, time to first token "
          f"(s) {[round(x, 4) for x in res['ttft_s']]}")
    print(f"  realtime report {res['report']}; request 0 -> "
          f"{results[0][:8]}", flush=True)
    return by_design


def serve_profile_phase(torch, dev) -> None:
    """One served batch (4 prompts of 1,024 tokens, 32 tokens out) through
    ``run_serve`` on weights drawn from the same seed: its tokens against
    the model's own prefill/decode_step loop, the same loop with the naive
    attention (reported), then its device time by kernel and idle share."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import parse_args, run_serve
    from repro_torch.models import transformer

    args = parse_args(SERVE_ARGS[2:] + ["--requests", "4"])
    config = get_config(args.arch)
    params = transformer.init(torch.Generator(device=dev).manual_seed(
        args.seed), config)
    res = run_serve(args, device=dev, params=params)   # warm
    res = run_serve(args, device=dev, params=params)   # unprofiled wall
    wall_ms = res["stream_s"] * 1e3
    # the same prompts through the model's own prefill/decode_step loop
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(np.stack([
        rng.integers(0, config.vocab_size, (args.prompt_len,), dtype=np.int32)
        for _ in range(args.requests)]).astype(np.int64)).to(dev)
    direct, lk = _greedy(torch, params, config, prompts, args.gen)
    if [res["results"][i] for i in range(args.requests)] != direct.tolist():
        raise AssertionError("run_serve's tokens differ from the model's "
                             "own prefill/decode_step loop")
    print(f"  run_serve's {args.requests} x {args.gen} tokens equal the "
          f"model's prefill/decode_step loop on the same prompts", flush=True)
    # replayed with the naive attention (reported): where a request's
    # tokens first part, both runs saw the same context, so the top-2 logit
    # gaps there say whether the kernel's rounding tipped a near tie
    naive, ln = _greedy(torch, params, config.replace(attention_impl="naive"),
                        prompts, args.gen)
    same = [bool((direct[i] == naive[i]).all()) for i in range(args.requests)]
    print(f"  the batch replayed with naive attention: {sum(same)}/"
          f"{args.requests} requests give the same {args.gen} tokens "
          f"(reported)", flush=True)
    for i in (i for i in range(args.requests) if not same[i]):
        t = int((direct[i] != naive[i]).nonzero()[0, 0])
        gk = lk[t][i].topk(2).values
        gn = ln[t][i].topk(2).values
        print(f"    request {i}: first differs at token {t} of {args.gen}; "
              f"top-2 logit gap there {float(gk[0] - gk[1]):.4g} with the "
              f"kernel, {float(gn[0] - gn[1]):.4g} naive; max|logit diff| "
              f"{float((lk[t][i] - ln[t][i]).abs().max()):.4g}", flush=True)
    for attempt in (1, 2):
        before = kernels.launch_counts()["flash_attention"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_serve(args, device=dev, params=params)
        launched = kernels.launch_counts()["flash_attention"] - before
        seen = sum(1 for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and any(k in ev.name for k in FLASH_KERNELS))
        if seen == launched:
            break
        print(f"  profile {attempt}: the profiler saw {seen} of the "
              f"{launched} flash launches")
    else:
        print("  profile: launches missing from the trace; idle share not "
              "measured")
        return
    by_kernel = _device_us(torch, prof)
    busy_ms = sum(by_kernel.values()) / 1e3
    flash_ms = sum(us for name, us in by_kernel.items()
                   if any(k in name for k in FLASH_KERNELS)) / 1e3
    gemm_ms = sum(us for name, us in by_kernel.items()
                  if not any(k in name for k in FLASH_KERNELS)
                  and any(m in name.lower() for m in GEMM_MARKERS)) / 1e3
    print(f"  one batch (4 x {args.prompt_len} tokens, {args.gen} out): "
          f"wall {wall_ms:.3f} ms unprofiled (prefill "
          f"{res['prefill_s'][0] * 1e3:.3f} ms, decode "
          f"{res['decode_s'][0] * 1e3:.3f} ms); device busy {busy_ms:.3f} ms "
          f"(profiled, {seen} flash launches seen of {launched}), idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.4f}; flash kernel "
          f"{flash_ms:.3f} ms, GEMMs {gemm_ms:.3f} ms, the rest "
          f"{busy_ms - flash_ms - gemm_ms:.3f} ms")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {us / 1e3:10.3f} ms {100 * us / 1e3 / busy_ms:5.1f}%  "
              f"{name[:90]}")


def restart_phase(torch, dev, smi: str) -> None:
    """The restart-safe windowed path at Table II size: run_restart kills a
    spawned consumer mid-window and resumes it; the windows are then held
    to an uncrashed in-process run of each window on the card."""
    from repro_torch import kernels
    from repro_torch.apps.ptycho.sim import simulate
    from repro_torch.apps.ptycho.solver import SolverConfig
    from repro_torch.apps.ptycho.stream import (parse_args,
                                                reconstruct_window,
                                                run_restart)

    args = parse_args(RESTART_ARGS + ["--out", str(OUT / "restart")])
    kernels.reset_launch_counts()
    res = run_restart(args, device=dev)
    counts = kernels.launch_counts()
    want = {f"win-{k:04d}": list(range(k * RESTART_WINDOW,
                                       (k + 1) * RESTART_WINDOW))
            for k in range(RESTART_WINDOWS)}
    got = {k: w["frames"] for k, w in res["windows"].items()}
    if got != want:
        raise AssertionError(f"restart window set {sorted(got)} != "
                             f"{sorted(want)}")
    fired = res["fired_on_resume"]
    if not set(want) - set(res["windows_at_crash"]) <= set(fired):
        raise AssertionError(f"the resumed run fired {fired}, but "
                             f"{res['windows_at_crash']} were on disk")
    steps = len(fired) * RESTART_ITERS
    expect = {"modulus_project": steps, "raar_combine": steps,
              "overlap_products": len(fired) * (2 * RESTART_ITERS - 2),
              "art_sweep": 0, "flash_attention": 0}
    if counts != expect or res["launches"] != expect:
        raise AssertionError(f"resumed launches {counts} (run_restart "
                             f"reports {res['launches']}) != {expect}")
    problem = simulate(args.obj_size, args.probe_size, args.scan_step,
                       device=dev)
    positions = torch.as_tensor(problem.positions, device=dev)
    cfg = SolverConfig(beta=0.75, iterations=RESTART_ITERS)
    worst = 0.0
    for key, win in sorted(res["windows"].items()):
        ref = reconstruct_window(problem, positions, win["frames"],
                                 RESTART_ITERS, cfg)
        rel = abs(win["fourier_err"] - ref) / abs(ref)
        worst = max(worst, rel)
        print(f"  {key}: fourier err {win['fourier_err']:.6f}, uncrashed "
              f"{ref:.6f}, rel. diff {rel:.3g}")
        if not (math.isfinite(ref) and rel <= RESTART_RTOL):
            raise AssertionError(f"{key}: restart error {win['fourier_err']}"
                                 f" vs uncrashed {ref} (rtol {RESTART_RTOL})")
    print(f"  restart OK on {smi}: SIGKILL at offset {res['kill_offset']} "
          f"({res['kill_offset'] % RESTART_WINDOW} frames in the open "
          f"window), on disk at the crash {res['windows_at_crash']}; the "
          f"resumed run fired {len(fired)} windows with launches {counts}; "
          f"{len(got)} windows of {RESTART_WINDOW} frames, max rel. diff "
          f"{worst:.3g} (tol {RESTART_RTOL}); produce {res['produce_s']:.4f}"
          f" s, reopen (log, state, checkpoint) {res['reopen_s']:.4f} s, "
          f"resumed run {res['resume_s']:.4f} s", flush=True)


HA_ARGS = ["--frames", "512", "--obj-size", "448", "--probe-size", "64"]
HA_FRAMES, HA_RTOL = 512, 1e-6


def ha_phase(torch, dev, smi: str) -> None:
    """Broker HA under the card's consumer: a durable primary in its own
    process SIGKILLed after 256 of 512 §III frames, its follower promoted,
    the producer and the consumer each failing over through their own
    ``FailoverBroker``; every frame held to the simulated one and the
    card's reductions to numpy's, the zombie fenced, no segment left."""
    from repro_torch import kernels
    from repro_torch.apps.ptycho.ha_failover import (PARTITIONS, parse_args,
                                                     run_ha_failover)

    args = parse_args(HA_ARGS)
    kernels.reset_launch_counts()
    res = run_ha_failover(args, device=dev)
    counts = kernels.launch_counts()
    # numpy over the frames read back from the promoted broker, each held
    # bit for bit to the producer's by its CRC-32
    want = {"photons": res["readback_photons"], "peak": res["readback_peak"]}
    errs = {k: abs(res[k] - v) / abs(v) for k, v in want.items()}
    prod, cons = res["producer"], res["consumer"]
    side = args.probe_size
    print(f"  {res['frames']} frames of ({side}, {side}) fp32 "
          f"({res['frames'] * side * side * 4 / 2**20:.1f} MiB) on "
          f"{PARTITIONS} partitions, the primary SIGKILLed after "
          f"{res['kill_after']}: "
          f"{len(res['frame_ids'])} frame ids in the sink, the last "
          f"{res['last_frame_s']:.4f} s after the topic appeared "
          f"({res['frames'] / res['last_frame_s']:.1f} frames/s); kill to "
          f"the producer's next frame {res['kill_to_first_produce_s']:.4f} "
          f"s; {prod['produce_calls']} produce calls in "
          f"{prod['produce_s']:.4f} s ({prod['before_kill_s']:.4f} s "
          f"before the kill), flushed {prod['flushed']}; "
          f"{res['stored']} records on the promoted broker, "
          f"{res['duplicates']} duplicates from the resend window, read "
          f"back equal {res['readback_equal']}; failovers: producer "
          f"{prod['failovers']} (epoch {prod['epoch']}), consumer "
          f"{cons['failovers']} (epoch {cons['epoch']}), "
          f"{cons['cursors_rewound']} cursors rewound, {cons['records']} "
          f"records consumed; {res['realtime']['batches']} batches, mean "
          f"processing {res['realtime']['mean_processing_s'] * 1e3:.3f} "
          f"ms; launches {counts}", flush=True)
    print(f"  ha failover OK on {smi}: zombie fenced ({res['fenced']}: "
          f"{res['zombie_error']}); photons {res['photons']:.6e} (numpy "
          f"{want['photons']:.6e}), peak {res['peak']:.6f} (numpy "
          f"{want['peak']:.6f}), rel. diff {max(errs.values()):.3g} (tol "
          f"{HA_RTOL}); shm left by this run's processes "
          f"{res['shm_left']}", flush=True)
    ids = list(range(HA_FRAMES))
    if not (res["frames"] == HA_FRAMES and res["frame_ids"] == ids
            and res["readback_ids"] == ids and res["readback_equal"]):
        raise AssertionError(f"frames {res['frames']}, sink ids "
                             f"{len(res['frame_ids'])}, read back "
                             f"{len(res['readback_ids'])}, equal "
                             f"{res['readback_equal']} (mismatched "
                             f"{res['readback_mismatched'][:8]})")
    if not max(errs.values()) <= HA_RTOL:
        raise AssertionError(f"card {res['photons']}, {res['peak']} vs "
                             f"numpy {want}")
    for name, client in (("producer", prod), ("consumer", cons)):
        if not (client["failovers"] >= 1 and client["epoch"] == 1):
            raise AssertionError(f"{name}: {client}")
    if not (prod["flushed"] and res["zombie_error"] and res["fenced"]):
        raise AssertionError(f"flushed {prod['flushed']}, zombie "
                             f"{res['zombie_error']}, fenced {res['fenced']}")
    if res["shm_left"]:
        raise AssertionError(f"shm left: {res['shm_left']}")
    if any(counts.values()):
        raise AssertionError(f"kernels launched: {counts}")


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
    library_kernels = sdpa_kernels(torch, dev)

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
    del problem

    print("[7] the ART kernel against its plain version (float32, tol 1e-4; "
          "float64 reported):", flush=True)
    l2_flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    art_row = art_phase(torch, dev, l2_flush.zero_)
    del l2_flush
    rows.append(art_row)

    print("[8] the tomography stream at full width:", flush=True)
    art_row["launches"], tomo_volume = tomo_phase(torch, dev, art_row["ms"])
    tomo_profile_phase(torch, dev)

    # before the cache is cleared: the two consumers share phase 8's system
    print("[14] a §IV consumer-group handoff at full width:", flush=True)
    art_row["launches_group_handoff"] = group_phase(torch, dev, tomo_volume,
                                                    smi)
    del tomo_volume
    from repro_torch.apps.tomo.solver import clear_system_cache
    clear_system_cache()            # the 4.75 GiB system off the card
    torch.cuda.empty_cache()

    print("[9] the flash-attention kernels against their plain version (fp32 "
          "tol 1e-5, bf16 2e-2):", flush=True)
    l2_flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    wgmma_row, tf32x3_row, simt_row = flash_phase(torch, dev,
                                                  l2_flush.zero_)
    del l2_flush
    rows += [wgmma_row, tf32x3_row, simt_row]
    wgmma_row["library_kernels"] = library_kernels["bfloat16"]
    tf32x3_row["library_kernels"] = library_kernels["float32"]

    print(f"[10] {ARCH} at full width:", flush=True)
    # the fp32 invariant's direct prefill/decode_step loop, not the served
    # path: under a name of its own
    tf32x3_row["launches_fp32_invariant"] = model_phase(torch, dev)

    print("[11] the serve stream at full width:", flush=True)
    by_design = serve_phase(torch, dev)
    wgmma_row["launches"] = by_design["wgmma"]
    tf32x3_row["launches"] = by_design["tf32x3"]
    simt_row["launches"] = by_design["simt"]
    serve_profile_phase(torch, dev)

    print("[12] the §III restart at Table II size:", flush=True)
    restart_phase(torch, dev, smi)

    print("[13] the remote ingest at the §III frame shape:", flush=True)
    remote_phase(torch, dev, smi)

    print("[15] broker HA under the card's consumer at the §III frame "
          "shape:", flush=True)
    ha_phase(torch, dev, smi)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
