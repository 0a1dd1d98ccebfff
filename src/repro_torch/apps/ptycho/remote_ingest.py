"""Two-process near-real-time ingest: detector process -> socket -> consumer
on the GPU.

The port's counterpart of ``examples/remote_ingest.py``, the paper's Fig. 7
topology split across OS processes:

  producer process (spawned, host only)     consumer process (this one)
  -------------------------------------     ---------------------------
  DetectorSource (frame simulator, CPU)     Broker (in-memory logs)
    -> IngestRunner (block backpressure)    BrokerServer on a socket
    -> RemoteBroker ──── TCP/Unix ────────▶   -> StreamingContext batches
       (lag measured against the                -> frames to the card, photon
        offsets the consumer committed             count and peak there
        broker-side)                            -> commits pushed broker-side

The producer never shares memory with the consumer's Python objects: every
frame crosses the socket transport. Detector frames are ndarrays, so they
ride array frames, and on one host the producer negotiates shared-memory
``'S'`` frames (the bulk bytes go through a server-owned segment, only
descriptors cross the socket); the runner batches them through
``produce_many``. The producer's backpressure is bounded against what the
consumer has *processed*. The producer is the detector, so it runs on the
host and never initialises CUDA; the consumer stacks each micro-batch's
frames into one host tensor, copies it to the device and reduces it there.

Run:  PYTHONPATH=src python -m repro_torch.apps.ptycho.remote_ingest \\
          --frames 96
      PYTHONPATH=src python -m repro_torch.apps.ptycho.remote_ingest \\
          --addr /tmp/broker.sock
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.broker import Broker
from repro_torch.core.dstream import StreamingContext
from repro_torch.core.rdd import Context
from repro_torch.data.transport import parse_address, serve_broker
from repro_torch.utils import resolve_device

TOPIC = "frames"


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--obj-size", type=int, default=96)
    ap.add_argument("--probe-size", type=int, default=32)
    ap.add_argument("--batch", type=int, default=16,
                    help="max records per partition per micro-batch")
    ap.add_argument("--max-pending", type=int, default=64,
                    help="producer backpressure bound (records in flight)")
    ap.add_argument("--addr", default="127.0.0.1:0",
                    help='"host:port" for TCP (port 0 = ephemeral) or a '
                         "filesystem path for a Unix domain socket")
    return ap.parse_args(argv)


def produce_frames(address: Any, frames: int, obj_size: int, probe_size: int,
                   max_pending: int, report: Any) -> None:
    """Producer process: simulate the detector on the CPU and pump its frames
    over the socket; puts its ingest metrics on ``report``."""
    from repro_torch.apps.ptycho.sim import simulate
    from repro_torch.data.ingest import IngestConfig, IngestRunner
    from repro_torch.data.sources import DetectorSource
    from repro_torch.data.transport import RemoteBroker

    problem = simulate(obj_size, probe_size, step=max(8, probe_size // 4),
                       device="cpu")
    # the scan may hold fewer frames than asked for; the detector emits
    # min(frames, problem.num_frames) and the consumer checks against what
    # actually reached the broker
    source = DetectorSource(problem, max_frames=frames, emit_frames=True)
    remote = RemoteBroker(address)
    # the client doubles as the consumer view: lag() is served from the
    # offsets the consumer-side StreamingContext committed on its broker
    runner = IngestRunner(remote, consumer=remote)
    runner.add(source, IngestConfig(topic=TOPIC, partitions=2,
                                    policy="block", max_pending=max_pending,
                                    poll_batch=16))
    runner.run_inline(timeout=120)
    m = runner.metrics[0]
    print(f"[producer pid={os.getpid()}] pumped "
          f"{m.produced}/{len(source)} frames in "
          f"{m.produce_calls} batched produce calls "
          f"(~{m.produced / max(m.produce_calls, 1):.0f} frames/round trip), "
          f"blocked {m.blocked_s:.2f}s on backpressure, "
          f"max lag seen {m.max_observed_lag}", flush=True)
    report.put({"produced": m.produced, "produce_calls": m.produce_calls, "blocked_s": m.blocked_s,
                "max_observed_lag": m.max_observed_lag,
                "shm_frames_sent": remote.shm_frames_sent})
    remote.close()


def run_remote_ingest(args: argparse.Namespace,
                      device: str | torch.device = "cuda") -> dict[str, Any]:
    """Serve a broker, spawn the detector producer against it, and consume
    its frames in micro-batches on ``device``.

    Returns the frames consumed and appended, their ids, the photon count
    (sum of squared magnitudes) and peak magnitude computed on the device,
    the wall time from the topic's creation to the producer's exit (the
    reference's measure) and to the last frame consumed,
    ``realtime_report``, the producer's ingest metrics and the server's
    stats once the producer's connection closed."""
    dev = resolve_device(device)
    broker = Broker()
    server = serve_broker(broker, parse_address(args.addr))
    print(f"[consumer pid={os.getpid()}] broker served on {server.address}",
          flush=True)
    ctx = mp.get_context("spawn")
    report = ctx.SimpleQueue()
    producer = ctx.Process(
        target=produce_frames,
        args=(server.address, args.frames, args.obj_size, args.probe_size,
              args.max_pending, report),
        name="detector-producer")
    producer.start()
    try:
        sc = StreamingContext(Context(), broker, batch_interval=0.05,
                              max_records_per_partition=args.batch)
        # the producer creates the topic over the wire; wait for it
        while TOPIC not in broker.topics():
            if not producer.is_alive():
                raise RuntimeError(
                    f"producer died before creating the topic (exit code "
                    f"{producer.exitcode})")
            time.sleep(0.01)
        sc.subscribe([TOPIC])

        stats: dict[str, Any] = {"frames": 0, "photons": 0.0, "peak": 0.0,
                                 "ids": [], "last_at": 0.0}

        def process(rdd, info):
            frames = rdd.collect()         # (index, magnitude_frame) payloads
            host = torch.from_numpy(np.stack([f for _, f in frames]))
            mags = host.to(dev)
            photons, peak = torch.stack(
                [torch.square(mags).sum(), mags.max()]).tolist()
            stats["frames"] += len(frames)
            stats["photons"] += photons
            stats["peak"] = max(stats["peak"], peak)
            stats["ids"].extend(i for i, _ in frames)
            stats["last_at"] = time.perf_counter()
            print(f"  batch {info.index}: {len(frames)} frames over the "
                  f"wire, {stats['frames']} total, lag {sc.lag(TOPIC)}")

        sc.foreach_batch(process)
        t0 = time.perf_counter()
        while producer.is_alive() or sc.lag(TOPIC) > 0:
            if sc.run_one_batch() is None:
                time.sleep(0.005)
        producer.join(timeout=30)
        wall = time.perf_counter() - t0
        consume = stats["last_at"] - t0
        if producer.exitcode != 0:
            raise RuntimeError(f"producer exited with {producer.exitcode}")
        produced = report.get()
        # the handler thread releases the producer's shm pool before it
        # drops the connection, so once no connection is left the server's
        # stats count no segment of it
        deadline = time.monotonic() + 10
        while (server.stats()["connections"]
               and time.monotonic() < deadline):
            time.sleep(0.005)
        served = server.stats()
    finally:
        if producer.is_alive():
            producer.kill()
            producer.join(timeout=10)
        server.stop()
        if isinstance(server.address, str) and os.path.exists(server.address):
            os.unlink(server.address)

    rep = sc.realtime_report()
    appended = sum(broker.end_offsets(TOPIC))
    print(f"\nconsumed {stats['frames']} frames in {wall:.2f}s "
          f"({stats['frames'] / max(wall, 1e-9):.0f} frames/s over the "
          f"socket; the last frame after {consume:.3f}s, "
          f"{stats['frames'] / max(consume, 1e-9):.0f} frames/s) on {dev}; "
          f"total photons {stats['photons']:.3e}, "
          f"peak magnitude {stats['peak']:.2f}")
    print(f"micro-batches: {rep['batches']}, mean processing "
          f"{rep['mean_processing_s'] * 1e3:.1f} ms, keeps up with "
          f"{sc.batch_interval * 1e3:.0f} ms interval: {rep['keeps_up']}")
    print(f"server stats: {served['requests_served']} requests served, "
          f"{served['frames_rejected']} frames rejected, "
          f"{served['shm_frames']} shm frames, "
          f"{served['shm_segments']} shm segments left")
    assert appended > 0 and stats["frames"] == appended, \
        f"lost frames: consumed {stats['frames']} != appended {appended}"
    print("remote ingest complete: every frame crossed the socket exactly "
          "once (block policy; no drops possible)")
    return {"frames": stats["frames"], "appended": appended,
            "frame_ids": sorted(stats["ids"]), "photons": stats["photons"],
            "peak": stats["peak"], "wall_s": wall, "consume_s": consume,
            "realtime": rep,
            "batch_interval": sc.batch_interval, "producer": produced,
            "server": served, "address": server.address}


def main() -> None:
    run_remote_ingest(parse_args())


if __name__ == "__main__":
    main()
