"""The §IV tilt-series stream, closed loop, dispatched ahead.

The window drives the composition ``apps/tomo/stream.py:run_stream``
makes, from the program's own parts: a ``Broker`` topic, a
``NearRealTimePipeline`` whose process step parallelizes each micro-batch
into RDD partitions and runs the app's ``reconstruct_partition`` (one ART
call each) on a ``TaskScheduler`` with speculation, then the app's
``NpzDirectorySink`` and ``MetricsSink``. The benchmark adds the producer,
the loop and the timing: it streams the seed's tilt series again and
again, each pass's slices numbered on from the last so that their keys
differ and the idempotent sink writes every one, and keeps
``queued_batches`` micro-batches waiting on the topic before each batch.

Correct: every sub-volume committed to the sink, read back from its file
once the window has closed, against the plain reference's ART of the same
sinogram rows (``reference/tomo.py``), which builds its own system matrix.
The number compared is the largest difference over all of them as a share
of the reference volume's largest magnitude.
"""
from __future__ import annotations

import functools
import os
import shutil
import tempfile
import time

import numpy as np

from port_bench import bench, loop
from port_bench.reference import tomo as ref

TOPIC = "tilt-series"


def inputs(cfg: dict, seed: int, device) -> tuple:
    """The seed's tilt series: (sinogram (nslice, nrow) on the device, the
    tilt angles, the system's non-zeros)."""
    import torch

    angles = ref.angles_deg(cfg["angles"], cfg["half_range_deg"])
    A = ref.projection_matrix(cfg["nray"], angles, device)
    vol = ref.phantom(cfg["nslice"], cfg["nray"], seed, device)
    with torch.no_grad():
        sino = vol.reshape(cfg["nslice"], -1) @ A.T
    nnz = int(torch.count_nonzero(A))
    return sino, angles, nnz


def reference_volume(cfg: dict, sino, angles, tf32: bool = False):
    """The plain reference's slices (nslice, nray²) of ``sino``."""
    A = ref.projection_matrix(cfg["nray"], angles, sino.device)
    cols, vals, inv = ref.padded_rows(A)
    del A
    return ref.art(sino, cols, vals, inv, cfg["nray"] ** 2,
                   cfg["iterations"], cfg["beta"], tf32=tf32)


def volume_error(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got - want).abs().max() / want.abs().max())


def control_readings(cfg: dict, traffic: dict, seed: int, device: str
                     ) -> dict:
    """The control's reading: the reference's ART with its products'
    operands in TF32, in the program's place, against the reference."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    sino, angles, _ = inputs(cfg, seed, torch.device(device))
    want = reference_volume(cfg, sino, angles)
    control = reference_volume(cfg, sino, angles, tf32=True)
    return {"volume_err.control_tf32": volume_error(control, want)}


def run(job: bench.Job) -> dict:
    import torch

    from repro_torch.apps.tomo import solver
    from repro_torch.apps.tomo.stream import reconstruct_partition
    from repro_torch.core.bridge import TorchBridge
    from repro_torch.core.broker import Broker
    from repro_torch.core.pipeline import NearRealTimePipeline, PipelineConfig
    from repro_torch.core.rdd import Context, TaskScheduler
    from repro_torch.data.sinks import MetricsSink, NpzDirectorySink
    from repro_torch.kernels import launch_counts

    cfg, traffic, settings = job.config, job.traffic, job.settings
    dev = torch.device(job.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    nslice, batch = cfg["nslice"], cfg["batch_slices"]
    sino, angles, nnz = inputs(cfg, job.seed, dev)
    sino_host = sino.cpu().numpy()
    if dev.type == "cuda":     # the peak is the program's, from here on
        torch.cuda.reset_peak_memory_stats(dev)

    # the program's set-up: its system matrix, row norms and CSR
    tcfg = solver.TomoConfig(nray=cfg["nray"], angles=tuple(angles.tolist()),
                             beta=cfg["beta"], iterations=cfg["iterations"])
    solver.system_on_device(tcfg, dev)
    broker = Broker()
    broker.create_topic(TOPIC, partitions=1)
    ctx = Context(scheduler=TaskScheduler(
        num_executors=cfg["executors"], speculation=cfg["speculation"]))
    out = tempfile.mkdtemp(prefix="port_bench_tomo_")
    sink = NpzDirectorySink(out)
    part_fn = functools.partial(reconstruct_partition, config=tcfg,
                                device=dev)
    if job.fault == "state_unchanged":       # the harness's own tests
        def part_fn(items, _fn=part_fn):
            idx, block = _fn(items)
            return idx, np.zeros_like(block)

    def process(rdd, info, bridge):
        # apps/tomo/stream.py:run_stream's process step
        records = sorted(rdd.collect())
        if not records:
            return None
        parts = ctx.parallelize(records, min(cfg["partitions"], len(records))
                                ).map_partitions(part_fn).collect_partitions()
        if job.fault == "answer_altered" and info.index == 1:
            parts[0][1][0, 0, 0] += 1.0
        return [(f"slices-{idx[0]:04d}-{idx[-1]:04d}",
                 {"idx": np.asarray(idx, np.int64), "block": block})
                for idx, block in parts]

    pipeline = NearRealTimePipeline(
        broker, PipelineConfig(topics=(TOPIC,), batch_interval=0.02,
                               max_records_per_partition=batch),
        process, bridge=TorchBridge(device=dev), context=ctx,
        sinks=[sink, MetricsSink()])
    streaming = pipeline.streaming
    produced = 0

    def unit() -> int:
        nonlocal produced
        while streaming.lag(TOPIC) < traffic["queued_batches"] * batch:
            i = produced % nslice
            broker.produce(TOPIC, (produced, sino_host[i]),
                           key=f"slice-{produced:06d}".encode())
            produced += 1
        info = streaming.run_one_batch()
        return info.num_records

    try:
        for _ in range(traffic["warmup_batches"]):
            unit()
        first = streaming.history[-1].index + 1
        rec: dict = {"setup_s": time.perf_counter() - job.t_start}
        window_s, slices, batches = loop.window(unit, job.seconds)
        rec.update(window_s=window_s, slices=int(slices),
                   window_units=batches,
                   spans=[s.as_dict() for s in streaming.traces.last()
                          if s.batch_index >= first])
        rec["art_nnz"], rec["nrow"] = nnz, sino.shape[1]
        rec["ncol"], rec["sweeps"] = cfg["nray"] ** 2, cfg["iterations"]
        rec["partition_slices"] = batch // cfg["partitions"]
        rec["partitions"] = cfg["partitions"]
        if job.trace and dev.type == "cuda":
            rec["trace"] = loop.traced(
                unit, settings["trace_batches"],
                {"art": ("repro_torch.kernels.art.ops", "art_reconstruct")},
                launched=lambda: launch_counts()["art_sweep"])
        rec["device"] = bench.device_info(torch, job.device)
        committed = sum(info.num_records for info in streaming.history)
        scheduler_metrics = dict(ctx.scheduler.metrics)
        pipeline.close()
        del pipeline, streaming, ctx
        solver.clear_system_cache()
        loop.release(torch)

        # correct: every committed sub-volume against the reference
        want = reference_volume(cfg, sino, angles)
        got_n, err, nbytes = 0, 0.0, 0
        peak = float(want.abs().max())
        for key in sink.keys_on_disk():
            path = sink.path_for(key)
            nbytes += os.path.getsize(path)
            with np.load(path) as z:
                idx, block = z["idx"], z["block"]
            w = want[torch.from_numpy(idx % nslice).to(dev)]
            got = torch.from_numpy(block).to(dev).reshape(w.shape)
            err = max(err, float((got - w).abs().max()) / peak)
            got_n += len(idx)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    limit = settings["limits"]["volume_err"]
    checks = [{"name": "volume_err", "value": err, "limit": limit},
              {"name": "slices_missing", "value": committed - got_n,
               "limit": 0}]
    rec["bytes_written"] = nbytes
    stages = {k: [sp["stages"].get(k, 0.0) for sp in rec["spans"]]
              for k in ("batch_fn", "sinks")}
    bench.log("tomo: spans " + ", ".join(
        f"{k} mean {np.mean(v):.4f} min {np.min(v):.4f} max {np.max(v):.4f}"
        for k, v in stages.items()))
    bench.log(f"tomo: {rec['slices']} slices in {window_s:.3f} s, "
            f"{nbytes} bytes written, {got_n} sub-volume slices read back; "
            f"scheduler {scheduler_metrics}")
    rec["checks"] = checks
    rec["correct"] = err <= limit and got_n == committed
    rec["attempted"], rec["failed"] = rec["slices"], 0
    return rec
