"""Broker HA under a consumer on the GPU: SIGKILL the primary mid-stream,
keep producing, keep consuming.

The port's counterpart of ``examples/ha_failover.py``, with §III detector
frames for records and a consumer whose batches go to the card:

  primary process (its own interpreter)   this process
  ------------------------------------    ------------------------------
  Broker on a DurableLogFactory,          ReplicaFollower: pulls the
  commit topic, served on a Unix          primary's CRC frames into its
  socket                                  own durable log, served as the
        ▲                                 standby (read-only until
        │ produce_many                    promoted)
  producer process (spawned, host only)   StreamingContext on a
  DetectorSource frames keyed by frame    FailoverBroker: batches to the
  id, through a FailoverBroker            card, photons and peak there,
                                          a sink keyed by frame id

The producer streams the frames in batches onto :data:`PARTITIONS`
partitions. Once half of them were produced the primary is SIGKILLed. The
producer's next call fails over: its ``FailoverBroker`` promotes the
follower at epoch 1, re-sends the batches no follower had confirmed, and
goes on; the consumer's own ``FailoverBroker`` finds the promoted broker
on its next call, and the streaming context rebases its cursor onto the
promoted log. At the end every frame id must be
in the consumer's sink and every frame read back from the promoted broker
must equal the one the producer simulated, bit for bit: the producer reports
each frame's CRC-32 (the CPU simulation is not bit-reproducible across
processes, so the frames are held to the producer's own). Duplicates from
the resend window collapse in the sink, which is keyed by frame id
(at-least-once delivery). The killed primary is then restarted on its old
log, a zombie at epoch 0, and fenced.

The primary runs in an interpreter of its own, so its shared-memory
segments (the producer's frames ride ``'S'`` frames on one host) are
registered with a resource tracker of its own, which unlinks them when the
primary is killed. Neither the primary nor the producer initialises CUDA.

Run:  PYTHONPATH=src python -m repro_torch.apps.ptycho.ha_failover \\
          --frames 512 --obj-size 448 --probe-size 64
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from typing import Any

import numpy as np
import torch

import repro_torch
from repro_torch.core.broker import BrokerFencedError, OffsetRange
from repro_torch.core.dstream import StreamingContext
from repro_torch.core.rdd import Context
from repro_torch.data.replication import FailoverBroker, ReplicaFollower
from repro_torch.data.transport import RemoteBroker
from repro_torch.utils import resolve_device

TOPIC = "frames"
PARTITIONS = 2
MAX_RECORDS = 32                 # frames a partition a consumer micro-batch
SHM_PREFIX = "reprotorchshm_"

# The primary: a durable broker with the commit topic, served on a Unix
# socket; a restarted one reopens its old log and commits.
_PRIMARY = """\
import sys, threading
from repro_torch.core.broker import COMMIT_TOPIC, Broker
from repro_torch.data.durable_log import DurableLogFactory
from repro_torch.data.transport import serve_broker
factory = DurableLogFactory(sys.argv[1])
broker = Broker(log_factory=factory, commit_topic=COMMIT_TOPIC)
factory.restore(broker)
broker.restore_commits()
serve_broker(broker, sys.argv[2])
print("ready", flush=True)
threading.Event().wait()
"""


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--obj-size", type=int, default=96)
    ap.add_argument("--probe-size", type=int, default=32)
    ap.add_argument("--batch", type=int, default=16,
                    help="frames a produce call")
    return ap.parse_args(argv)


def _scan_step(probe_size: int) -> int:
    return max(8, probe_size // 4)


def start_primary(root: str, sock: str) -> subprocess.Popen:
    """Start a primary broker process on ``root``'s log, served on the Unix
    socket ``sock``; returns once it serves."""
    if os.path.exists(sock):
        os.unlink(sock)              # a killed primary leaves its socket file
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.Popen([sys.executable, "-c", _PRIMARY, root, sock],
                            stdout=subprocess.PIPE, env=env, text=True)
    line = proc.stdout.readline().strip()
    if line != "ready":
        proc.kill()
        proc.wait()
        raise RuntimeError(f"primary broker did not start (said {line!r}, "
                           f"exit code {proc.poll()})")
    return proc


def produce_frames(addresses: list, frames: int, obj_size: int,
                   probe_size: int, batch: int, kill_after: int,
                   to_parent: Any, from_parent: Any) -> None:
    """Producer process: simulate the detector on the CPU and stream its
    frames through a ``FailoverBroker``. Once ``kill_after`` frames were
    produced it asks the parent to kill the primary and waits for the kill;
    at the end it waits for a follower to confirm every batch and puts its
    report, with each frame's CRC-32, on ``to_parent``."""
    from repro_torch.apps.ptycho.sim import simulate
    from repro_torch.data.sources import DetectorSource

    problem = simulate(obj_size, probe_size, step=_scan_step(probe_size),
                       device="cpu")
    source = DetectorSource(problem, max_frames=frames, emit_frames=True)
    client = FailoverBroker(addresses)
    client.create_topic(TOPIC, PARTITIONS)
    produced, calls, t_first_after, t_kill_asked = 0, 0, None, None
    killed = False
    crcs: dict[int, int] = {}
    t0 = time.monotonic()
    while not source.exhausted:
        pairs = source.poll(batch)
        if not pairs:
            continue
        for _, (i, frame) in pairs:
            crcs[i] = zlib.crc32(frame)
        client.produce_many(TOPIC, pairs)
        produced += len(pairs)
        calls += 1
        if killed and t_first_after is None:
            t_first_after = time.monotonic()
        if not killed and produced >= kill_after:
            t_kill_asked = time.monotonic()
            to_parent.put(("kill", produced))
            from_parent.get()            # the primary is dead now
            killed = True
    produce_s = time.monotonic() - t0
    flushed = client.flush(timeout=30.0)
    to_parent.put(("done", {
        "produced": produced, "produce_calls": calls,
        "produce_s": produce_s, "first_after_kill": t_first_after,
        "before_kill_s": (t_kill_asked - t0 if t_kill_asked is not None
                          else None),
        "flushed": flushed, "failovers": client.failovers,
        "epoch": client.epoch, "active": client.active_address,
        "crcs": crcs}))
    client.close()


def _shm_left(pids: list[int]) -> list[str]:
    prefixes = tuple(f"{SHM_PREFIX}{pid}_" for pid in pids)
    return sorted(f for f in os.listdir("/dev/shm") if f.startswith(prefixes))


def run_ha_failover(args: argparse.Namespace,
                    device: str | torch.device = "cuda") -> dict[str, Any]:
    """Start the primary, its follower and the producer, kill the primary
    mid-stream, and consume every frame on ``device`` throughout.

    Returns the frame ids in the consumer's sink, the photon count and peak
    over the deduplicated frames (reduced on the device) and numpy's over
    the frames read back from the promoted broker, whether each of those
    equals the frame the producer simulated, the duplicates the resend
    window left, the cursors the consumer's rebase rewound, both clients'
    failovers and epochs, the seconds from the kill to the producer's first
    frame after it and to the last frame consumed, the zombie's fencing and
    the shared-memory segments left."""
    from repro_torch.apps.ptycho.sim import scan_grid

    dev = resolve_device(device)
    frame_shape = (args.probe_size, args.probe_size)
    n_frames = min(args.frames, len(scan_grid(
        args.obj_size, args.probe_size, _scan_step(args.probe_size))))
    kill_after = n_frames // 2
    work = tempfile.mkdtemp(prefix="ha_failover_")
    psock = os.path.join(work, "p.sock")
    primary = zombie = producer = None
    follower = consumer_client = None
    pids = [os.getpid()]
    try:
        primary = start_primary(os.path.join(work, "primary"), psock)
        pids.append(primary.pid)
        follower = ReplicaFollower(psock, os.path.join(work, "replica"),
                                   poll_interval=0.005)
        standby = follower.serve(os.path.join(work, "f.sock"))
        follower.start()
        print(f"[ha] primary pid={primary.pid} on {psock}, standby "
              f"{standby}; {n_frames} frames of {frame_shape}, "
              f"SIGKILL after {kill_after}", flush=True)

        ctx = mp.get_context("spawn")
        to_parent, from_parent = ctx.SimpleQueue(), ctx.SimpleQueue()
        producer = ctx.Process(
            target=produce_frames,
            args=([psock, standby], n_frames, args.obj_size, args.probe_size,
                  args.batch, kill_after, to_parent, from_parent),
            name="detector-producer")
        producer.start()

        consumer_client = FailoverBroker([psock, standby])
        while TOPIC not in consumer_client.topics():
            if not producer.is_alive():
                raise RuntimeError(f"producer died before creating the "
                                   f"topic (exit code {producer.exitcode})")
            time.sleep(0.005)
        sc = StreamingContext(Context(), consumer_client, batch_interval=0.05,
                              max_records_per_partition=MAX_RECORDS)
        sc.subscribe([TOPIC])
        sink: dict[int, tuple[float, float]] = {}
        seen = {"records": 0, "last_new": 0.0}

        def process(rdd, info):
            frames = rdd.collect()            # (frame id, magnitudes)
            mags = torch.from_numpy(np.stack([f for _, f in frames])).to(dev)
            photons = torch.square(mags).sum(dim=(1, 2)).tolist()
            peaks = mags.amax(dim=(1, 2)).tolist()
            new = 0
            for (i, _), ph, pk in zip(frames, photons, peaks):
                new += i not in sink
                sink[i] = (ph, pk)           # idempotent by frame id
            seen["records"] += len(frames)
            if new:
                seen["last_new"] = time.monotonic()

        sc.foreach_batch(process)
        t0 = time.monotonic()
        t_kill = None
        report = None
        deadline = t0 + 300
        while report is None or sc.lag(TOPIC) > 0 or len(sink) < n_frames:
            if time.monotonic() > deadline:
                raise RuntimeError(f"consumer stalled: {len(sink)} of "
                                   f"{n_frames} frames, lag {sc.lag(TOPIC)}")
            while report is None and not to_parent.empty():
                what, body = to_parent.get()
                if what == "kill":
                    primary.kill()           # SIGKILL, mid-stream
                    primary.wait()
                    t_kill = time.monotonic()
                    print(f"[ha] SIGKILLed the primary after {body} frames",
                          flush=True)
                    from_parent.put("killed")
                else:
                    report = body
            if report is None and not producer.is_alive():
                raise RuntimeError(f"producer exited with "
                                   f"{producer.exitcode} before its report")
            if sc.run_one_batch() is None:
                time.sleep(0.002)
        producer.join(timeout=30)
        if producer.exitcode != 0:
            raise RuntimeError(f"producer exited with {producer.exitcode}")

        # every frame back from the promoted broker, duplicates and all
        readback: dict[int, bool] = {}
        mismatched: list[tuple[int, int, int]] = []
        photons_np, peak_np = 0.0, 0.0
        stored = 0
        for p in range(consumer_client.num_partitions(TOPIC)):
            end = consumer_client.end_offset(TOPIC, p)
            for rec in consumer_client.read(OffsetRange(TOPIC, p, 0, end)):
                i, frame = rec.value
                stored += 1
                same = (rec.key == f"frame-{i:06d}".encode()
                        and frame.dtype == np.float32
                        and frame.shape == frame_shape
                        and zlib.crc32(frame) == report["crcs"].get(i))
                if i not in readback:
                    mags = frame.astype(np.float64)
                    photons_np += float((mags ** 2).sum())
                    peak_np = max(peak_np, float(mags.max()))
                readback[i] = readback.get(i, True) and same
                if not same:
                    mismatched.append((p, rec.offset, i))

        # the dead primary restarted on its old log: a zombie at epoch 0
        zombie = start_primary(os.path.join(work, "primary"), psock)
        pids.append(zombie.pid)
        fenced = consumer_client.fence_stale()
        direct = RemoteBroker(psock, max_retries=1, retry_delay=0.01)
        try:
            direct.produce(TOPIC, (-1, np.zeros(frame_shape, np.float32)),
                           partition=0)
            zombie_error = None
        except BrokerFencedError as e:
            zombie_error = str(e)
        finally:
            direct.close()
        print(f"[ha] zombie pid={zombie.pid} fenced {fenced}: "
              f"{zombie_error}", flush=True)
        rep = sc.realtime_report()
        consumer = {"failovers": consumer_client.failovers,
                    "epoch": consumer_client.epoch,
                    "active": consumer_client.active_address,
                    "cursors_rewound": sc.cursors_rewound,
                    "records": seen["records"]}
        sc.close()
    finally:
        if producer is not None and producer.is_alive():
            producer.kill()
            producer.join(timeout=10)
        if consumer_client is not None:
            consumer_client.close()
        if follower is not None:
            follower.stop()
        for proc in (primary, zombie):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    # a killed primary's resource tracker unlinks its segments once it sees
    # the primary gone; the follower's server released the producer's when
    # its connection closed
    deadline = time.monotonic() + 10
    while _shm_left(pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    shm_left = _shm_left(pids)
    shutil.rmtree(work, ignore_errors=True)

    ids = sorted(sink)
    photons = float(sum(ph for ph, _ in sink.values()))
    peak = float(max((pk for _, pk in sink.values()), default=0.0))
    last_s = seen["last_new"] - t0
    out = {"frames": n_frames, "kill_after": kill_after, "frame_ids": ids,
           "photons": photons, "peak": peak,
           "readback_ids": sorted(readback),
           "readback_equal": all(readback.values()) and bool(readback),
           "readback_mismatched": mismatched,
           "readback_photons": photons_np, "readback_peak": peak_np,
           "stored": stored, "duplicates": stored - n_frames,
           "producer": report, "consumer": consumer, "realtime": rep,
           "kill_to_first_produce_s": (report["first_after_kill"] - t_kill
                                       if t_kill is not None
                                       and report["first_after_kill"]
                                       is not None else None),
           "last_frame_s": last_s, "fenced": fenced,
           "zombie_error": zombie_error, "shm_left": shm_left,
           "device": str(dev)}
    print(f"[ha] {len(ids)} of {n_frames} frames in the sink, the last "
          f"{last_s:.3f} s after the topic appeared "
          f"({n_frames / max(last_s, 1e-9):.0f} frames/s); kill to the "
          f"producer's next frame {out['kill_to_first_produce_s']} s; "
          f"{out['duplicates']} duplicates from the resend window; "
          f"failovers producer {report['failovers']} (epoch "
          f"{report['epoch']}), consumer {consumer['failovers']} (epoch "
          f"{consumer['epoch']}), {consumer['cursors_rewound']} cursors "
          f"rewound; photons {photons:.6e}, peak {peak:.6f} on {dev}; "
          f"shm left {shm_left}", flush=True)
    return out


def main() -> None:
    run_ha_failover(parse_args())


if __name__ == "__main__":
    main()
