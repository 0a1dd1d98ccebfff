"""End-to-end near-real-time ptychography on the GPU (paper §III, Figs. 7-10).

The port's counterpart of the main path of ``examples/ptycho_pipeline.py``:

  DetectorSource (frame simulator at the acquisition rate)
     --> broker topic --> StreamingContext micro-batches
     --> RAAR reconstruction on the accumulated frames (modulus, overlap
         and combine as CUDA kernels on the card)
     --> sinks: NpzDirectorySink artifacts + MetricsSink latency accounting
     --> refinement iterations, then phase correlation against the truth

The paper's near-real-time criterion: 512 frames arrive in ~25 s; the run
reports whether reconstruction kept pace. Each batch's time is taken after
its Fourier error reached the host, so it counts the device's work and not
only the launches.

Run:  PYTHONPATH=src python -m repro_torch.apps.ptycho.stream \
          --frames 512 --obj-size 256 --probe-size 64 --scan-step 8
(``--fast`` shrinks everything as the JAX example does.)
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any

import numpy as np
import torch

from repro_torch.apps.ptycho.sim import simulate
from repro_torch.apps.ptycho.solver import (SolverConfig, init_waves,
                                            raar_step, reconstruction_quality)
from repro_torch.core.bridge import TorchBridge
from repro_torch.core.broker import Broker
from repro_torch.core.pipeline import NearRealTimePipeline, PipelineConfig
from repro_torch.data.sinks import MetricsSink, NpzDirectorySink
from repro_torch.data.sources import DetectorSource
from repro_torch.kernels import launch_counts
from repro_torch.utils import resolve_device


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--obj-size", type=int, default=256)
    ap.add_argument("--probe-size", type=int, default=64)
    ap.add_argument("--scan-step", type=int, default=12)
    ap.add_argument("--frame-interval", type=float, default=0.0,
                    help="seconds between produced frames (paper: 0.05)")
    ap.add_argument("--batch-frames", type=int, default=64)
    ap.add_argument("--iters-per-batch", type=int, default=6)
    ap.add_argument("--final-iters", type=int, default=60)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--out", default="out")
    args = ap.parse_args(argv)
    if args.fast:
        args.frames, args.obj_size, args.probe_size = 81, 96, 32
        args.scan_step, args.batch_frames = 8, 27
        args.final_iters, args.iters_per_batch = 30, 4
    return args


def run_stream(args: argparse.Namespace,
               device: str | torch.device = "cuda") -> dict[str, Any]:
    """Stream the scan through the pipeline, refine, and score the result.

    Returns the per-batch Fourier errors, frames seen and times, the final
    error, the phase correlation against the truth, the pipeline report,
    the near-real-time verdict, the sink's keys and the kernel launches this
    run made."""
    dev = resolve_device(device)
    launches_before = launch_counts()
    t_setup = time.perf_counter()
    problem = simulate(args.obj_size, args.probe_size, args.scan_step,
                       device=dev)
    n_frames = min(args.frames, problem.num_frames)
    print(f"scan: {problem.num_frames} frames of "
          f"{problem.frame_shape}; streaming {n_frames} on {dev}")

    source = DetectorSource(problem, max_frames=n_frames,
                            frame_interval=args.frame_interval)
    artifact_sink = NpzDirectorySink(os.path.join(args.out, "ptycho"))
    metrics = MetricsSink()

    # reconstruction state (the solver warm-starts across micro-batches)
    cfg = SolverConfig(beta=0.75, iterations=args.final_iters)
    positions_all = torch.as_tensor(problem.positions, device=dev)
    mags_all = problem.magnitudes
    obj_shape = tuple(problem.object_true.shape)
    state: dict[str, Any] = {"probe": problem.probe_true, "n_seen": 0,
                             "psi": None, "obj": None, "iteration": 0}
    errs: list[float] = []
    seen: list[int] = []
    batch_times: list[float] = []
    setup_time = time.perf_counter() - t_setup

    def process(rdd, info, bridge):
        ids = rdd.collect()
        if not ids:
            return None
        t0 = time.perf_counter()
        n_new = state["n_seen"] + len(ids)
        mags = mags_all[:n_new]
        pos = positions_all[:n_new]
        fresh = init_waves(mags[state["n_seen"]:], state["probe"])
        psi = fresh if state["psi"] is None else torch.cat(
            [state["psi"], fresh])
        for _ in range(args.iters_per_batch):
            psi, obj, probe_new, err = raar_step(
                psi, mags, pos, state["probe"], obj_shape, cfg,
                state["iteration"], group=bridge.group)
            state["probe"] = probe_new
            state["iteration"] += 1
        state.update(psi=psi, obj=obj, n_seen=n_new)
        err = float(err)        # waits for the device's work on this batch
        dt = time.perf_counter() - t0
        errs.append(err)
        seen.append(n_new)
        batch_times.append(dt)
        print(f"  batch {info.index}: {n_new}/{n_frames} frames, "
              f"fourier err {err:.4f}, proc {dt:.3f}s")
        # keyed result -> idempotent sink (replays overwrite, not duplicate)
        return [(f"batch-{info.index:06d}",
                 {"fourier_err": np.float32(err),
                  "frames_seen": np.int32(n_new)})]

    pipeline = NearRealTimePipeline(
        Broker(),
        PipelineConfig(batch_interval=0.05,
                       max_records_per_partition=args.batch_frames // 2,
                       source_partitions=2),
        process, bridge=TorchBridge(device=dev),
        sinks=[metrics, artifact_sink])
    pipeline.subscribe_source(source, topic="frames")

    t0 = time.perf_counter()
    report = pipeline.run_until_drained()
    stream_time = time.perf_counter() - t0

    # refinement to convergence (the offline tail, paper Table II setup)
    psi, probe, obj = state["psi"], state["probe"], state["obj"]
    pos, mags = positions_all[:n_frames], mags_all[:n_frames]
    final_err = errs[-1]
    for it in range(args.final_iters):
        psi, obj, probe, err = raar_step(psi, mags, pos, probe, obj_shape,
                                         cfg, state["iteration"] + it)
        final_err = err
    final_err = float(final_err)
    total = time.perf_counter() - t0
    obj_host = obj.cpu().numpy()
    q = reconstruction_quality(obj_host, problem.object_true,
                               margin=args.probe_size // 2)
    # overwrite: the final object must track THIS run, not a previous one
    artifact_sink.write_batch([
        ("object-final", {"obj": obj_host,
                          "fourier_err": np.float32(final_err)})],
        overwrite=True)
    acq = 0.05 * n_frames
    rep = metrics.report()
    print(f"\nstreaming phase: {stream_time:.3f}s for {report.records} "
          f"frames ({rep['mean_latency_s']:.3f}s/batch, "
          f"{rep['throughput_rec_per_s']:.0f} rec/s)")
    print(f"total (incl. {args.final_iters} refinement iters): {total:.3f}s "
          f"vs paper acquisition window {acq:.1f}s "
          f"-> near-real-time: {total < acq}")
    print(f"final fourier error {final_err:.4f}, "
          f"phase correlation vs truth {q:.3f}")
    keys = artifact_sink.keys_on_disk()
    print(f"sink artifacts: {len(keys)} npz files in "
          f"{artifact_sink.directory}")
    after = launch_counts()
    return {"batch_errors": errs, "frames_seen": seen,
            "batch_times": batch_times, "final_error": final_err,
            "quality": q, "report": report, "metrics": rep,
            "setup_time": setup_time, "stream_time": stream_time,
            "total_time": total, "acquisition_window": acq,
            "near_real_time": total < acq, "sink_keys": keys,
            "iterations": state["iteration"] + args.final_iters,
            "launches": {k: after[k] - launches_before[k] for k in after}}


def main() -> None:
    run_stream(parse_args())


if __name__ == "__main__":
    main()
