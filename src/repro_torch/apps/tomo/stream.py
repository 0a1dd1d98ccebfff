"""End-to-end streaming tomography on the GPU (paper §IV, Figs. 11-16).

The port's counterpart of ``examples/tomo_pipeline.py``:

  ProjectionSource (one record per sinogram slice, at the acquisition rate)
     --> broker topic --> StreamingContext micro-batches
     --> each batch parallelized into RDD partitions of neighbouring slices
     --> one ART sweep call per partition (the CUDA kernel on the card), on
         a TaskScheduler of --partitions executors with speculation, each
         executor's partition on a CUDA stream of its own so that they
         overlap on the card: a failed partition is recomputed from
         lineage, a straggler gets a speculative copy
     --> sinks: NpzDirectorySink sub-volumes + MetricsSink latency accounting
     --> gather from the sink, score (sinogram residual, volume error), render

Sub-volumes are keyed ``slices-%04d-%04d`` in a directory named after the
run's shape, so a rerun with the same shape finds its keys on disk and
writes nothing new. Each batch's time is taken after its sub-volumes
reached the host, so it counts the device's work. With ``--obs-port`` the
run serves its metrics registry and batch spans over HTTP while it
streams, reads them back through the endpoint before ``close()``, and
prints where each batch's time went, stage by stage.

Run:  PYTHONPATH=src python -m repro_torch.apps.tomo.stream \\
          --nray 256 --angles 76 --nslice 256
"""
from __future__ import annotations

import argparse
import functools
import os
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.apps.tomo.projector import make_system
from repro_torch.apps.tomo.render import render_volume
from repro_torch.apps.tomo.solver import (TomoConfig, reconstruct_slices,
                                          residual, simulate_tilt_series,
                                          system_on_device)
from repro_torch.core.bridge import TorchBridge
from repro_torch.core.broker import Broker
from repro_torch.core.pipeline import NearRealTimePipeline, PipelineConfig
from repro_torch.core.rdd import Context, TaskScheduler
from repro_torch.data.metrics import (MetricsRegistry, get_registry,
                                      set_registry)
from repro_torch.data.obs_server import print_stream_scrape, scrape_stream
from repro_torch.data.sinks import MetricsSink, NpzDirectorySink
from repro_torch.data.sources import ProjectionSource
from repro_torch.kernels import launch_counts
from repro_torch.utils import resolve_device


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nray", type=int, default=64)
    ap.add_argument("--nslice", type=int, default=32)
    ap.add_argument("--angles", type=int, default=25)
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--partitions", type=int, default=4)
    ap.add_argument("--slice-interval", type=float, default=0.0,
                    help="seconds between streamed slices (acquisition rate)")
    ap.add_argument("--obs-port", type=int, default=None,
                    help="serve the observability endpoint on this port "
                         "while the pipeline runs (0 = ephemeral port)")
    ap.add_argument("--out", default="out")
    return ap.parse_args(argv)


_executor = threading.local()


def _own_stream(device: torch.device) -> torch.cuda.Stream:
    """The calling thread's CUDA stream on ``device``, taken from PyTorch's
    stream pool (no allocation) on the thread's first partition there; a
    ``TaskScheduler``'s threads live for one job, so each batch's executors
    take theirs anew. Before its first use it waits once on the device's
    current stream, so that whatever the caller enqueued there before
    handing partitions out is complete before any read."""
    streams = getattr(_executor, "streams", None)
    if streams is None:
        streams = _executor.streams = {}
    s = streams.get(device)
    if s is None:
        s = streams[device] = torch.cuda.Stream(device)
        s.wait_stream(torch.cuda.current_stream(device))
    return s


def reconstruct_partition(items: list, config: TomoConfig,
                          device: torch.device) -> tuple[list, np.ndarray]:
    """One RDD partition's work: its ``(slice_index, sinogram_row)`` records
    to the device as one block, one ART call, the sub-volume back on the
    host. Returns the slice indices and the (k, Nray, Nray) sub-volume.

    On a CUDA device the whole of it (the block's copy, the sweep, the
    result's copy back) runs on the calling executor thread's own stream
    (``_own_stream``), so the executors' partitions overlap on the card and
    a result returns when its own sweep ends; ``art_own_stream_calls_total``
    counts those calls. Both copies go through pinned host memory: a
    pageable copy is staged through the driver's buffer, which another
    partition's pageable result copy holds until that partition's sweep
    has ended, so the partitions would still wait for each other."""
    idx = [i for i, _ in items]
    rows = torch.from_numpy(np.stack([b for _, b in items]))
    device = torch.device(device)
    if device.type != "cuda":
        return idx, reconstruct_slices(rows.to(device), config).cpu().numpy()
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    # held until the result is on the host: the stream reads the cached
    # system, which must not be freed while the sweep may still run
    system = system_on_device(config, device)
    stream = _own_stream(device)
    with torch.cuda.stream(stream):
        f = reconstruct_slices(rows.pin_memory().to(device, non_blocking=True),
                               config)
        get_registry().counter(
            "art_own_stream_calls_total",
            "ART calls enqueued on an executor thread's own CUDA stream").inc()
        out = torch.empty(f.shape, dtype=f.dtype, pin_memory=True)
        out.copy_(f, non_blocking=True)
    stream.synchronize()
    del system
    # out of the pinned buffer, which then goes back to PyTorch's cache: a
    # caller may keep the block (a StreamingContext's history keeps each
    # batch's result), and pinned memory kept would grow with the stream
    return idx, out.numpy().copy()


def run_stream(args: argparse.Namespace,
               device: str | torch.device = "cuda",
               scheduler: TaskScheduler | None = None) -> dict[str, Any]:
    """Stream the tilt series through the pipeline, gather, score, render.

    The batches' partitions run on ``scheduler``, by default the example's
    ``TaskScheduler(num_executors=args.partitions, speculation=True)``; a
    caller passes one with a ``FailureInjector`` to lose partitions and
    slow one down.

    Returns the sinogram residual and volume error of the gathered volume
    and of each slice, the gathered volume, the batch times, the set-up time
    with the system matrix's host build and its copy to the device apart,
    the stream time, the RDD partitions processed, the sink's keys, the
    scheduler's ``metrics`` (tasks, retries, speculative copies and their
    wins) and the ART launches this run made (a speculative copy launches
    the kernel too, and so does an abandoned straggler once it wakes,
    which may be after this returns); with ``--obs-port``, also ``obs``: the
    endpoint's roll-up (:func:`~repro_torch.data.obs_server.scrape_stream`),
    read over HTTP into a registry of this run's own, and the seconds that
    read and the endpoint's stop took, which the stream time leaves
    out."""
    dev = resolve_device(device)
    launches_before = launch_counts()["art_sweep"]
    cfg = TomoConfig(nray=args.nray,
                     angles=tuple(np.linspace(-75, 75, args.angles).tolist()),
                     iterations=args.iterations)
    t_setup = time.perf_counter()
    make_system(cfg.nray, np.asarray(cfg.angles))
    build_time = time.perf_counter() - t_setup
    t0 = time.perf_counter()
    system_on_device(cfg, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    copy_time = time.perf_counter() - t0
    # step 1: the tilt series streams in as (slice_index, sinogram_row)
    vol_true, sino, sino_host = simulate_tilt_series(cfg, args.nslice,
                                                     device=dev)
    source = ProjectionSource(sino_host, interval=args.slice_interval)
    # per-run-shape directory: the gather below reads every key on disk, so
    # sub-volumes from a differently-shaped run must not share the store
    # (same-shape reruns resume idempotently)
    run_tag = f"{args.nslice}x{args.nray}x{args.angles}x{args.iterations}"
    sink = NpzDirectorySink(os.path.join(args.out,
                                         f"tomo_subvolumes_{run_tag}"))
    metrics = MetricsSink()
    ctx = Context(scheduler=scheduler or TaskScheduler(
        num_executors=args.partitions, speculation=True))
    batch_slices = max(1, args.nslice // args.partitions)
    batch_times: list[float] = []
    n_partitions = 0
    setup_time = time.perf_counter() - t_setup
    print(f"tomography: {args.nslice} slices of {args.nray}^2, "
          f"{args.angles} angles, {sino.shape[1]} rays a slice, on {dev}; "
          f"system matrix host build {build_time:.2f} s, copy "
          f"{copy_time:.2f} s, set-up {setup_time:.2f} s")

    # steps 2+3 per micro-batch: repartition neighbouring slices, ART sweep
    def process(rdd, info, bridge):
        nonlocal n_partitions
        records = sorted(rdd.collect())          # (i, row), scan order
        if not records:
            return None
        t0 = time.perf_counter()
        part = ctx.parallelize(records, min(args.partitions, len(records)))
        parts = part.map_partitions(functools.partial(
            reconstruct_partition, config=cfg,
            device=dev)).collect_partitions()
        n_partitions += len(parts)
        dt = time.perf_counter() - t0
        batch_times.append(dt)
        print(f"  batch {info.index}: {len(records)} slices in "
              f"{len(parts)} partitions, proc {dt:.3f}s")
        return [(f"slices-{idx[0]:04d}-{idx[-1]:04d}",
                 {"idx": np.asarray(idx, np.int64), "block": block})
                for idx, block in parts]

    # with the endpoint on, the run's components register into a registry
    # of its own, so its counters count this run alone
    prev_registry = set_registry(MetricsRegistry()
                                 if args.obs_port is not None
                                 else get_registry())
    try:
        pipeline = NearRealTimePipeline(
            Broker(),
            PipelineConfig(batch_interval=0.02,
                           max_records_per_partition=batch_slices),
            process, bridge=TorchBridge(device=dev), context=ctx,
            sinks=[sink, metrics])
        pipeline.subscribe_source(source, topic="tilt-series")
    finally:
        set_registry(prev_registry)
    obs = None
    if args.obs_port is not None:
        obs = pipeline.serve_observability(("127.0.0.1", args.obs_port))
        print(f"observability endpoint: {obs.url}")

    t0 = time.perf_counter()
    report = pipeline.run_until_drained()
    stream_time = time.perf_counter() - t0
    scrape, scrape_s = None, 0.0
    if obs is not None:        # read THROUGH the endpoint, then stop it
        t_scrape = time.perf_counter()
        scrape = scrape_stream(obs.url)
        # stopped here rather than in close(): its serve loop polls every
        # 0.5 s, which the stream time must not count
        obs.stop()
        scrape_s = time.perf_counter() - t_scrape
    pipeline.close()

    # step 4: gather sub-volumes from the checkpoint store, score, render
    recon = np.zeros((args.nslice, args.nray, args.nray), np.float32)
    for key in sink.keys_on_disk():
        with np.load(sink.path_for(key)) as z:
            recon[z["idx"]] = z["block"]
    rec = torch.from_numpy(recon).to(dev)
    r = residual(rec, sino, cfg)
    r_slice = residual(rec, sino, cfg, per_slice=True)
    diff = (rec - vol_true).reshape(args.nslice, -1)
    truth = vol_true.reshape(args.nslice, -1)
    err = float(torch.linalg.vector_norm(diff)
                / torch.linalg.vector_norm(truth))
    err_slice = (torch.linalg.vector_norm(diff, dim=1)
                 / (torch.linalg.vector_norm(truth, dim=1) + 1e-12)
                 ).cpu().numpy()
    rep = metrics.report()
    print(f"ART: {args.nslice} slices x {args.nray}^2, {args.angles} angles, "
          f"{args.iterations} sweeps on {args.partitions} partitions: "
          f"{stream_time:.3f}s ({rep['batches']} micro-batches, "
          f"{args.nslice / stream_time:.1f} slices/s)")
    print(f"sinogram residual {r:.4f}; volume rel. error {err:.4f}")
    print(f"scheduler metrics: {ctx.scheduler.metrics}")
    if scrape is not None:
        print_stream_scrape(scrape)
    keys = sink.keys_on_disk()
    print(f"sub-volume artifacts: {len(keys)} npz files in {sink.directory}")
    paths = render_volume(recon, args.out)
    print("artifacts:", paths)
    return {"residual": r, "error": err, "slice_residuals": r_slice,
            "slice_errors": err_slice, "volume": recon,
            "batch_times": batch_times, "setup_time": setup_time,
            "matrix_build_time": build_time, "matrix_copy_time": copy_time,
            "stream_time": stream_time, "report": report, "metrics": rep,
            "partitions": n_partitions, "sink_keys": keys,
            "scheduler_metrics": dict(ctx.scheduler.metrics),
            "obs": scrape, "obs_scrape_s": scrape_s,
            "launches": launch_counts()["art_sweep"] - launches_before}


def main() -> None:
    run_stream(parse_args())


if __name__ == "__main__":
    main()
