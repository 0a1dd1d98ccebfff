"""Training entry point: streaming micro-batch LM training on the Spark-MPI
stack.

The counterpart of ``repro/launch/train.py``, the paper's pattern end to
end: a token producer appends sequences to the broker; the
StreamingContext cuts them into micro-batch RDDs; each batch becomes one
train step on the card (the "MPI application"); checkpoints are written
asynchronously, and ``--resume`` continues from the committed offsets and
the last checkpoint.

The reference's ``--reduced`` cannot be turned off but by ``--full``
(``store_true`` with ``default=True``); here it is off unless given, and
the entry point trains the full model, as the port's serve serves it.
The weights are random, drawn from ``--seed``. ``run_train`` runs on the
card unless the caller asks for the CPU; the CLI wants CUDA and raises
without it.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch internlm2-1.8b --reduced --steps 50 --batch 4 --seq 128 \\
        --ckpt-dir /tmp/ck
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import ModelConfig, get_config
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.broker import Broker
from repro_torch.core.dstream import StreamingContext
from repro_torch.core.rdd import Context
from repro_torch.data.metrics import span
from repro_torch.kernels import launch_counts
from repro_torch.training import build_train_step, init_state
from repro_torch.utils import get_logger, resolve_device, tree_any_nan

log = get_logger(__name__)


def synthetic_producer(broker: Broker, config: ModelConfig, steps: int,
                       batch: int, seq: int, seed: int = 0) -> None:
    """Stands in for the detector or corpus: one record a sequence, its
    tokens, then a vlm record's image embeddings and an audio record's
    frames, fp32, drawn in that order from one generator."""
    rng = np.random.default_rng(seed)
    for _ in range(steps * batch):
        rec = {"tokens": rng.integers(
            0, config.vocab_size, (seq,), dtype=np.int32)}
        if config.family == "vlm":
            rec["image_embeds"] = rng.standard_normal(
                (config.num_image_tokens, config.d_model)).astype(np.float32)
        if config.family == "audio":
            rec["frames"] = rng.standard_normal(
                (config.encoder_seq, config.d_model)).astype(np.float32)
        broker.produce("tokens", rec)


def assemble_batch(records: list[dict], config: ModelConfig,
                   device: str | torch.device = "cpu") -> dict:
    """The records stacked on ``device``: tokens as int64, image
    embeddings and frames in bf16, as the reference casts them; the span
    ``assemble_batch``."""
    with span("assemble_batch"):
        batch = {"tokens": torch.from_numpy(np.stack(
            [r["tokens"] for r in records]).astype(np.int64)).to(device)}
        for name in {"vlm": ("image_embeds",),
                     "audio": ("frames",)}.get(config.family, ()):
            batch[name] = torch.from_numpy(
                np.stack([r[name] for r in records])).to(device,
                                                         torch.bfloat16)
        return batch


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="train the arch's tiny variant (CPU tests)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    return ap.parse_args(argv)


def run_train(args: argparse.Namespace, device: str | torch.device = "cuda"
              ) -> dict[str, Any]:
    """Train ``args.arch`` (its ``reduced()`` variant under ``--reduced``)
    ``args.steps`` steps on the stream from ``args.seed``.

    Returns the steps taken (``steps``, the
    last step's number in ``step``), each step's loss and wall time
    (``losses``, ``step_s``: from the batch's records to its loss on the
    host), the stream's wall time and tokens/s, the ``realtime_report``,
    the final ``state`` and the kernel launches this run made."""
    dev = resolve_device(device)
    config = get_config(args.arch, reduced=args.reduced)
    if config.family == "vlm" and args.seq <= config.num_image_tokens:
        args.seq = config.num_image_tokens + args.seq
    opt = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps, zero1=False)
    launches_before = launch_counts()

    if args.ckpt_dir:       # the offsets are written before any checkpoint
        os.makedirs(args.ckpt_dir, exist_ok=True)

    # data plane: broker + streaming context
    broker = Broker()
    broker.create_topic("tokens", partitions=2)
    synthetic_producer(broker, config, args.steps, args.batch, args.seq,
                       args.seed)
    sc = StreamingContext(Context(), broker,
                          max_records_per_partition=args.batch,
                          checkpoint_path=(f"{args.ckpt_dir}/offsets.json"
                                           if args.ckpt_dir else None))
    sc.subscribe(["tokens"])

    # compute plane
    state = init_state(torch.Generator(device=dev).manual_seed(args.seed),
                       config, opt)
    start_step = 0
    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if (args.resume and args.ckpt_dir
            and latest_step(args.ckpt_dir) is not None):
        state, start_step = restore(args.ckpt_dir, state, device=dev)
        log.info("resumed from step %d", start_step)
    step_fn = build_train_step(config, opt)
    stats: dict[str, Any] = {"step": start_step, "state": state,
                             "tokens": 0, "losses": [], "step_s": []}
    del state

    def on_batch(rdd, info):
        records = rdd.collect()[: args.batch]
        if len(records) < args.batch:
            return None
        t0 = time.perf_counter()
        batch = assemble_batch(records, config, dev)
        stats["state"], metrics = step_fn(stats["state"], batch)
        loss = float(metrics["loss"])
        stats["step_s"].append(time.perf_counter() - t0)
        stats["losses"].append(loss)
        stats["step"] += 1
        stats["tokens"] += batch["tokens"].numel()
        s = stats["step"]
        if s % args.log_every == 0 or s == start_step + 1:
            dt = time.perf_counter() - t_start
            log.info("step %d loss %.4f lr %.2e gnorm %.2f | %.0f tok/s",
                     s, loss, float(metrics["lr"]),
                     float(metrics["grad_norm"]), stats["tokens"] / dt)
        if ckpt and s % args.ckpt_every == 0:
            ckpt.save(s, stats["state"])
        return loss

    sc.foreach_batch(on_batch)
    t_start = time.perf_counter()
    while stats["step"] < start_step + args.steps:
        if sc.run_one_batch() is None:
            break
    stream_s = time.perf_counter() - t_start
    # the context stays in the process-wide metrics registry, so it must
    # not keep the batch function, and with it the state
    sc.foreach_batch(None)
    if ckpt:
        ckpt.save(stats["step"], stats["state"])
        ckpt.wait()
    if tree_any_nan(stats["state"]["params"]):
        raise SystemExit("NaN in parameters")
    after = launch_counts()
    return {"config": config, "device": str(dev), "state": stats["state"],
            "step": stats["step"], "steps": len(stats["losses"]),
            "losses": stats["losses"], "step_s": stats["step_s"],
            "tokens": stats["tokens"], "stream_s": stream_s,
            "tokens_per_s": stats["tokens"] / stream_s if stream_s else 0.0,
            "report": sc.realtime_report(),
            "launches": {k: after[k] - launches_before[k] for k in after}}


def main(argv: list[str] | None = None) -> None:
    res = run_train(parse_args(argv))
    rep = res["report"]
    log.info("done: %d steps, %.0f rec/s, mean batch %.3fs, %.0f tok/s",
             res["step"], rep.get("throughput_rec_per_s", 0),
             rep.get("mean_processing_s", 0), res["tokens_per_s"])


if __name__ == "__main__":
    main()
