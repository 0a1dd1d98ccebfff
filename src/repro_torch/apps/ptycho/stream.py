"""End-to-end near-real-time ptychography on the GPU (paper §III, Figs. 7-10).

The port's counterpart of the main path of ``examples/ptycho_pipeline.py``:

  DetectorSource (frame simulator at the acquisition rate)
     --> broker topic --> StreamingContext micro-batches
     --> RAAR reconstruction on the accumulated frames (modulus, overlap
         and combine as CUDA kernels on the card)
     --> sinks: NpzDirectorySink artifacts + MetricsSink latency accounting
     --> refinement iterations, then phase correlation against the truth,
         and the object's phase rendered (paper Fig. 10)

The paper's near-real-time criterion: 512 frames arrive in ~25 s; the run
reports whether reconstruction kept pace. Each batch's time is taken after
its Fourier error reached the host, so it counts the device's work and not
only the launches. The artifact store rides its own delivery lane (retry
x2, bounded queue), so a slow disk cannot stall the batch loop; the lane's
counters are printed next to the MetricsSink report. With ``--obs-port``
the run serves its metrics registry and batch spans over HTTP while it
streams, reads them back through the endpoint before ``close()``, and
prints where each batch's time went, stage by stage.

With ``--elastic`` the detector is pumped by a threaded ``IngestRunner``
into a 2-partition topic, and a ``LagPolicy`` watches its backpressure
lag: when reconstruction falls behind it grows an ``ElasticController``'s
worker set, and the pipeline is handed the new bridge. The controller has
four worker slots on the card, the counterpart of the four virtual devices
the reference forces for ``--elastic``. As in the reference, ``process``
does not split its RAAR step over the bridge, so this exercises the
control loop (signal -> policy -> controller -> new bridge), not parallel
reconstruction.

With ``--restart`` the run is the reference's restart-safe windowed path
instead (:func:`run_restart`): the detector's frame ids land in a durable
log, RAAR runs once per *window* of frames on the device with the open
window in a ``DurableStateStore``, and a spawned consumer is SIGKILLed
mid-window. The resumed run restores the open window atomically with the
consumed offsets and must fire exactly the windows an uncrashed run fires.
Unlike the reference, ``--restart`` keeps the given size; ``--restart
--fast`` runs the reference's small one.

Run:  PYTHONPATH=src python -m repro_torch.apps.ptycho.stream \
          --frames 512 --obj-size 256 --probe-size 64 --scan-step 8
(``--fast`` shrinks everything as the JAX example does.)
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import shutil
import signal
import time
from typing import Any

import numpy as np
import torch

from repro_torch.apps.ptycho.sim import PtychoProblem, simulate
from repro_torch.apps.ptycho.solver import (SolverConfig, init_waves,
                                            raar_step, reconstruction_quality)
from repro_torch.apps.tomo.render import render_phase
from repro_torch.core.bridge import TorchBridge
from repro_torch.core.broker import Broker
from repro_torch.core.fault import ElasticController, LagPolicy
from repro_torch.core.pipeline import NearRealTimePipeline, PipelineConfig
from repro_torch.data.delivery import SinkPolicy
from repro_torch.data.durable_log import DurableLogFactory
from repro_torch.data.ingest import IngestConfig, IngestRunner
from repro_torch.data.metrics import (MetricsRegistry, get_registry,
                                      set_registry)
from repro_torch.data.obs_server import print_stream_scrape, scrape_stream
from repro_torch.data.sinks import MetricsSink, NpzDirectorySink
from repro_torch.data.sources import DetectorSource
from repro_torch.data.state import DurableStateStore
from repro_torch.data.window import WindowSpec
from repro_torch.kernels import _build, launch_counts
from repro_torch.utils import resolve_device

# --elastic: the worker slots on the card, the counterpart of the four
# virtual devices examples/ptycho_pipeline.py forces for --elastic
ELASTIC_WORKERS = 4


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
    ap.add_argument("--elastic", action="store_true",
                    help="threaded ingest + LagPolicy-driven elastic scaling")
    ap.add_argument("--restart", action="store_true",
                    help="SIGKILL mid-window + resume: restart-safe windowed "
                         "state (durable log + DurableStateStore)")
    ap.add_argument("--obs-port", type=int, default=None,
                    help="serve the observability endpoint (/metrics, "
                         "/metrics.json, /traces, /health) on this port "
                         "while the pipeline runs (0 = ephemeral port)")
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
    run made; with ``--obs-port``, also ``obs``: the endpoint's roll-up
    (:func:`~repro_torch.data.obs_server.scrape_stream`), read over HTTP
    into a registry of this run's own, and the seconds that read and the
    endpoint's stop took, which the stream and total times leave out.
    With ``--elastic``, also ``elastic``: the peak lag the policy saw, the
    records shed, the final world, the controller's events, the world after
    each batch, the world of each bridge handed to the pipeline, the number
    of policy observations, and the runner's ``max_pending`` and
    ``poll_batch``."""
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

    # with the endpoint on, the run's components register into a registry
    # of its own, so its counters count this run alone
    prev_registry = set_registry(MetricsRegistry()
                                 if args.obs_port is not None
                                 else get_registry())
    try:
        broker = Broker()
        if args.elastic:
            broker.create_topic("frames", 2)
        pipeline = NearRealTimePipeline(
            broker,
            PipelineConfig(topics=("frames",) if args.elastic else (),
                           batch_interval=0.05,
                           max_records_per_partition=args.batch_frames // 2,
                           source_partitions=2),
            process, bridge=TorchBridge(device=dev),
            # the artifact store on its own delivery lane: a slow disk
            # cannot stall the batch loop, and transient write errors retry
            # twice
            sinks=[metrics,
                   (artifact_sink, SinkPolicy.retry(2, queue_depth=32))])
        runner = controller = policy = None
        if args.elastic:
            # threaded ingest with block backpressure against the consumed
            # offsets; LagPolicy grows the worker set when reconstruction
            # falls behind
            controller = ElasticController(
                initial_workers=1, devices=[dev] * ELASTIC_WORKERS)
            policy = LagPolicy(scale_up_lag=args.batch_frames // 2,
                               scale_down_lag=max(1, args.batch_frames // 8),
                               sustain=2, cooldown=0.5)
            runner = IngestRunner(broker, consumer=pipeline.streaming)
            runner.add(source, IngestConfig(
                topic="frames", partitions=2, policy="block",
                poll_batch=args.batch_frames,
                max_pending=4 * args.batch_frames))
        else:
            pipeline.subscribe_source(source, topic="frames")
    finally:
        set_registry(prev_registry)
    worlds: list[int] = []
    handed: list[int] = []
    if args.elastic:
        def drive_elastic(info):
            # on a scale event, hand the pipeline the new bridge
            if policy.drive(controller, runner) != 0:
                pipeline.bridge = controller.bridge()
                handed.append(pipeline.bridge.world)
            worlds.append(controller.world)

        pipeline.streaming.add_sink(drive_elastic)
        print(f"elastic: starting on {controller.world}/"
              f"{controller.max_workers} workers")
    obs = None
    if args.obs_port is not None:
        obs = pipeline.serve_observability(("127.0.0.1", args.obs_port),
                                           lag_policy=policy)
        print(f"observability endpoint: {obs.url}")

    t0 = time.perf_counter()
    if runner is not None:
        runner.start()
    try:
        report = pipeline.run_until_drained(
            producer_done=(lambda: runner.done) if runner else None)
    finally:
        if runner is not None:
            runner.stop()
    scrape, scrape_s = None, 0.0
    if obs is not None:        # read THROUGH the endpoint, then stop it
        t_scrape = time.perf_counter()
        scrape = scrape_stream(obs.url)
        # stopped here rather than in close(): its serve loop polls every
        # 0.5 s, which the stream time must not count
        obs.stop()
        scrape_s = time.perf_counter() - t_scrape
    pipeline.close()           # drain the artifact lane: all batches on disk
    stream_time = time.perf_counter() - t0 - scrape_s

    # refinement to convergence (the offline tail, paper Table II setup)
    psi, probe, obj = state["psi"], state["probe"], state["obj"]
    pos, mags = positions_all[:n_frames], mags_all[:n_frames]
    final_err = errs[-1]
    for it in range(args.final_iters):
        psi, obj, probe, err = raar_step(psi, mags, pos, probe, obj_shape,
                                         cfg, state["iteration"] + it)
        final_err = err
    final_err = float(final_err)
    total = time.perf_counter() - t0 - scrape_s
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
    lanes = pipeline.delivery_report()
    for name, lane in lanes.items():
        print(f"sink lane {name}: delivered {lane['delivered']}, "
              f"failed {lane['failed']}, retries {lane['retries']}, "
              f"max depth {lane['max_depth']}, "
              f"mean latency {lane.get('mean_latency_s', 0.0):.4f}s")
    if scrape is not None:
        # the spans answer "which stage took the time", per batch epoch
        print_stream_scrape(scrape)
    elastic = None
    if args.elastic:
        shed = sum(m.dropped + m.sampled_out for m in runner.metrics)
        peak = max((o.lag for o in policy.history), default=0)
        print(f"elastic: peak consumer lag {peak} records, {shed} shed; "
              f"world {controller.world}/{controller.max_workers} after "
              f"{len(controller.events)} scale event(s)")
        for ev in controller.events:
            print(f"  gen {ev.generation}: {ev.reason} (world {ev.world})")
        elastic = {"peak_lag": peak, "shed": shed, "world": controller.world,
                   "events": list(controller.events), "worlds": worlds,
                   "handed": handed, "observations": len(policy.history),
                   "max_pending": 4 * args.batch_frames,
                   "poll_batch": args.batch_frames}
    print(f"final fourier error {final_err:.4f}, "
          f"phase correlation vs truth {q:.3f}")
    keys = artifact_sink.keys_on_disk()
    print(f"sink artifacts: {len(keys)} npz files in "
          f"{artifact_sink.directory}")
    paths = render_phase(obj_host, args.out)
    print("artifacts:", paths)
    after = launch_counts()
    return {"batch_errors": errs, "frames_seen": seen,
            "batch_times": batch_times, "final_error": final_err,
            "quality": q, "report": report, "metrics": rep,
            "setup_time": setup_time, "stream_time": stream_time,
            "total_time": total, "acquisition_window": acq,
            "near_real_time": total < acq, "sink_keys": keys,
            "lanes": lanes, "obs": scrape, "obs_scrape_s": scrape_s,
            "elastic": elastic, "artifacts": paths,
            "iterations": state["iteration"] + args.final_iters,
            "launches": {k: after[k] - launches_before[k] for k in after}}


def reconstruct_window(problem: PtychoProblem, positions: torch.Tensor,
                       ids: np.ndarray, iters: int, config: SolverConfig
                       ) -> float:
    """RAAR over one window of frames, warm-started from ``init_waves`` and
    the true probe as the reference's restart consumer does; returns the
    last step's Fourier error (read on the host, after the device's work)."""
    idx = torch.as_tensor(ids, device=positions.device)
    mags, pos = problem.magnitudes[idx], positions[idx]
    obj_shape = tuple(problem.object_true.shape)
    probe = problem.probe_true
    psi = init_waves(mags, probe)
    for it in range(iters):
        psi, _, probe, err = raar_step(psi, mags, pos, probe, obj_shape,
                                       config, it)
    return float(err)


def _restart_consume(root: str, sim_args: tuple, window: int, batch: int,
                     iters: int, device: str, sleep_s: float = 0.0
                     ) -> dict[str, Any]:
    """Consumer half of ``--restart``: windowed RAAR over the durable log,
    with restart-safe window state. Run once in a spawned child (killed
    mid-window), then again in-process to resume from the checkpoint.
    Returns the seconds to reopen the log, the state and the checkpoint,
    the seconds of the run, and the keys of the windows it fired."""
    dev = resolve_device(device)
    problem = simulate(*sim_args, device=dev)
    positions = torch.as_tensor(problem.positions, device=dev)
    cfg = SolverConfig(beta=0.75, iterations=iters)
    fired: list[str] = []

    def process(frame_ids, winfo, bridge):
        ids = np.asarray(sorted(frame_ids))
        err = reconstruct_window(problem, positions, ids, iters, cfg)
        tag = "partial-" if winfo.partial else ""
        key = f"win-{tag}{winfo.index:04d}"
        fired.append(key)
        print(f"  window {tag}{winfo.index}: frames "
              f"[{ids[0]}..{ids[-1]}], fourier err {err:.4f}", flush=True)
        return (key, {"frames": ids, "fourier_err": np.float32(err)})

    t0 = time.perf_counter()
    factory = DurableLogFactory(os.path.join(root, "wal"))
    broker = Broker(log_factory=factory)
    factory.restore(broker)                # reopen the on-disk frame log
    pipeline = NearRealTimePipeline(
        broker,
        PipelineConfig(topics=("frames",), batch_interval=0.01,
                       max_records_per_partition=batch,
                       checkpoint_path=os.path.join(root, "ckpt.json")),
        process, bridge=TorchBridge(device=dev),
        window=WindowSpec(size=window),
        window_state=DurableStateStore(os.path.join(root, "wstate")),
        sinks=[NpzDirectorySink(os.path.join(root, "windows"))])
    reopen_s = time.perf_counter() - t0
    if sleep_s:                            # slow the batch loop so the
        pipeline.streaming.add_sink(       # parent can catch it mid-window
            lambda info: time.sleep(sleep_s))
    t0 = time.perf_counter()
    try:
        pipeline.run_until_drained(producer_done=lambda: True,
                                   idle_timeout=0.2)
        pipeline.flush_windows()   # partial window -> keyed sinks, THEN ckpt
    finally:
        pipeline.close()
    return {"reopen_s": reopen_s, "run_s": time.perf_counter() - t0,
            "fired": fired}


def _consumed(ckpt: str) -> int:
    """Records the checkpoint says were consumed (0 before the first)."""
    try:
        with open(ckpt) as f:
            return sum(sum(v) for v in json.load(f)["offsets"].values())
    except (OSError, ValueError, KeyError):
        return 0


def run_restart(args: argparse.Namespace,
                device: str | torch.device = "cuda") -> dict[str, Any]:
    """The restart-safe windowed path: produce the scan's frame ids into a
    durable log, SIGKILL a spawned windowed consumer mid-window, resume
    in-process, and hold the windows on disk to the uncrashed set (full
    windows plus the ``win-partial-…`` tail). Raises if any of it fails.

    Returns the kill offset, the windows on disk at the crash, each
    window's frame ids and Fourier error, the produce, reopen and resume
    seconds, the windows the resumed run fired and its kernel launches."""
    dev = resolve_device(device)
    root = os.path.join(args.out, "ptycho-restart")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    sim_args = (args.obj_size, args.probe_size, args.scan_step)
    problem = simulate(*sim_args, device=dev)
    n_frames = min(args.frames, problem.num_frames)
    window, batch = args.batch_frames, max(1, args.batch_frames // 3)
    iters = args.iters_per_batch
    print(f"restart: {n_frames} frames -> durable log, window {window}, "
          f"{batch} frames a batch, {iters} RAAR steps a window on {dev}")
    if dev.type == "cuda":
        # build here, so the child only loads the library: two processes
        # building at once would both run nvcc
        _build.build()

    t0 = time.perf_counter()
    producer = Broker(log_factory=DurableLogFactory(os.path.join(root, "wal")))
    producer.create_topic("frames", 1)
    source = DetectorSource(problem, max_frames=n_frames)
    while not source.exhausted:
        producer.produce_many("frames", source.poll(64), partition=0)
    produce_s = time.perf_counter() - t0

    # spawn, not fork: a forked child would inherit this process's CUDA
    # context, which it cannot use
    consume = (root, sim_args, window, batch, iters, str(dev))
    proc = multiprocessing.get_context("spawn").Process(
        target=_restart_consume, args=consume + (0.3,), daemon=True)
    proc.start()
    ckpt = os.path.join(root, "ckpt.json")
    deadline = time.monotonic() + 300
    try:
        while True:
            if not proc.is_alive():
                raise RuntimeError(
                    f"the consumer exited (code {proc.exitcode}) before it "
                    "could be killed mid-window")
            if time.monotonic() > deadline:
                raise RuntimeError("never caught the consumer mid-window")
            consumed = _consumed(ckpt)
            if consumed > window and consumed % window != 0:
                os.kill(proc.pid, signal.SIGKILL)
                break
            time.sleep(0.01)
    finally:
        if proc.is_alive():
            proc.kill()
        proc.join(timeout=30)
    print(f"SIGKILL at {consumed} frames consumed ({consumed % window} in "
          f"the open window)")
    sink = NpzDirectorySink(os.path.join(root, "windows"))
    at_crash = sink.keys_on_disk()
    print(f"windows on disk at the crash: {at_crash}")

    print("resuming from the (offsets, window state) checkpoint ...")
    before = launch_counts()
    resumed = _restart_consume(*consume)
    after = launch_counts()

    windows: dict[str, dict[str, Any]] = {}
    for key in sink.keys_on_disk():
        with np.load(sink.path_for(key)) as z:
            windows[key] = {"frames": z["frames"].tolist(),
                            "fourier_err": float(z["fourier_err"])}
    expect = {f"win-{k:04d}": list(range(k * window, (k + 1) * window))
              for k in range(n_frames // window)}
    if n_frames % window:
        k = n_frames // window
        expect[f"win-partial-{k:04d}"] = list(range(k * window, n_frames))
    got = {k: w["frames"] for k, w in windows.items()}
    if got != expect:
        raise RuntimeError(f"window set after the restart differs:\n  got "
                           f"{got}\n  want {expect}")
    print(f"restart OK: {len(got)} windows, the uncrashed window set; "
          f"produce {produce_s:.3f} s, reopen {resumed['reopen_s']:.3f} s, "
          f"resumed run {resumed['run_s']:.3f} s ({len(resumed['fired'])} "
          f"windows fired)")
    return {"kill_offset": consumed, "windows_at_crash": at_crash,
            "windows": windows, "fired_on_resume": resumed["fired"],
            "produce_s": produce_s, "reopen_s": resumed["reopen_s"],
            "resume_s": resumed["run_s"],
            "n_frames": n_frames, "window": window, "batch": batch,
            "iterations": iters,
            "launches": {k: after[k] - before[k] for k in after}}


def main() -> None:
    args = parse_args()
    if args.restart:
        run_restart(args)
    else:
        run_stream(args)


if __name__ == "__main__":
    main()
