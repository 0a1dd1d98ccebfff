"""End-to-end streaming tomography on the GPU (paper §IV, Figs. 11-16).

The port's counterpart of ``examples/tomo_pipeline.py``:

  ProjectionSource (one record per sinogram slice, at the acquisition rate)
     --> broker topic --> StreamingContext micro-batches
     --> each batch parallelized into RDD partitions of neighbouring slices
     --> one ART sweep call per partition (the CUDA kernel on the card)
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
from repro_torch.core.rdd import Context
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


def reconstruct_partition(items: list, config: TomoConfig,
                          device: torch.device) -> tuple[list, np.ndarray]:
    """One RDD partition's work: its ``(slice_index, sinogram_row)`` records
    to the device as one block, one ART call, the sub-volume back on the
    host. Returns the slice indices and the (k, Nray, Nray) sub-volume."""
    idx = [i for i, _ in items]
    block = torch.from_numpy(np.stack([b for _, b in items])).to(device)
    return idx, reconstruct_slices(block, config).cpu().numpy()


def run_stream(args: argparse.Namespace,
               device: str | torch.device = "cuda") -> dict[str, Any]:
    """Stream the tilt series through the pipeline, gather, score, render.

    Returns the sinogram residual and volume error of the gathered volume
    and of each slice, the gathered volume, the batch times, the set-up time
    with the system matrix's host build and its copy to the device apart,
    the stream time, the RDD partitions processed, the sink's keys and the
    ART launches this run made; with ``--obs-port``, also ``obs``: the
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
    ctx = Context()
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
            "obs": scrape, "obs_scrape_s": scrape_s,
            "launches": launch_counts()["art_sweep"] - launches_before}


def main() -> None:
    run_stream(parse_args())


if __name__ == "__main__":
    main()
