"""Serving entry point: batched request streaming through the Spark-MPI stack.

The counterpart of ``repro/launch/serve.py``. Requests (prompts) arrive on
a broker topic; the streaming context cuts them into micro-batches; each
batch is prefilled once (causal attention in the CUDA flash kernel, but
for a sliding window) and decoded greedily for ``--gen`` tokens with the
KV cache — the paper's near-real-time loop with a language model as the
"MPI application". It
reports per-batch prefill and decode times, the time to first token,
tokens/s and the stream's near-real-time report.

The reference's ``--reduced`` cannot be turned off (``store_true`` with
``default=True``), so it always serves the 2-layer, 64-wide toy; here it is
off unless given, and the entry point serves the full model. The weights
are random, drawn from ``--seed`` (nothing pretrained can be fetched).
``--arch`` is one of the ported archs (``repro_torch.configs.ARCHS``): the
dense internlm2-1.8b (the default), gemma-7b, minitron-8b and
starcoder2-3b, the MoE granite-moe-3b-a800m (kimi-k2-1t-a32b, about 1 T
parameters, is served at ``--reduced`` only: it does not fit one card),
the hybrid recurrentgemma-2b, whose attention is a 2,048-token sliding
window over a rolling cache (the ``blocked`` schedule past 512 positions,
naive below and in decode, as the reference's: no flash kernel runs for
it), the audio whisper-medium, the ssm rwkv6-7b,
attention-free with a constant-size state, and the vlm llava-next-34b.
Each family's ``prefill`` builds its own cache (``init_cache`` of its
module).

An audio request carries its ``frames`` besides its prompt: precomputed
frame embeddings (``encoder_seq``, ``d_model``) in fp32, drawn from the
same generator right after the prompt, as the reference's producer draws
them (``repro/launch/train.py:synthetic_producer``); a batch stacks them
into ``batch["frames"]``. The reference's serve sends tokens only, so its
whisper ``prefill`` cannot run there (``KeyError: 'frames'``). whisper's
encoder runs the ``blocked`` schedule and its cross-attention the naive
attention (the reference's rule: its kernel is for causal calls), its
decoder's causal prefill the flash kernel. A vlm request carries its ``image_embeds`` the same way,
(``num_image_tokens``, ``d_model``) fp32 drawn right after its prompt,
stacked into ``batch["image_embeds"]``; its prefill runs the image prefix
and the prompt as one causal sequence, so the cache holds
``num_image_tokens`` slots more and decode positions start after the
prefix. The reference's serve sends no images, so its llava requests are
text only; and its cache, sized by the prompt, would keep only the first
slots of an image-prefixed prefill.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch whisper-medium --requests 8 --batch 4 \\
        --prompt-len 384 --gen 64
"""
from __future__ import annotations

import argparse
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs import ModelConfig, get_config
from repro_torch.core.broker import Broker
from repro_torch.core.dstream import StreamingContext
from repro_torch.core.rdd import Context
from repro_torch.kernels import launch_counts
from repro_torch.models.registry import get_model
from repro_torch.training import build_serve_fns
from repro_torch.utils import get_logger, resolve_device

log = get_logger(__name__)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the arch's tiny variant (CPU tests)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def run_serve(args: argparse.Namespace, device: str | torch.device = "cuda",
              params: dict | None = None, config: ModelConfig | None = None
              ) -> dict[str, Any]:
    """Serve ``args.requests`` prompts in micro-batches of ``args.batch``.

    ``config`` is the model to serve, by default ``args.arch`` (its
    ``reduced()`` variant under ``--reduced``); ``params`` are its weights,
    by default drawn from ``args.seed`` on the device. Returns the greedy tokens by request
    id (``results``), the number of tokens served, per batch the prefill and
    decode times (each taken once that batch's tokens reached the host) and
    the time to first token of its requests (from the stream's start; every
    request is queued before it), the stream's wall time, tokens/s, the
    ``realtime_report`` and the kernel launches this run made."""
    dev = resolve_device(device)
    if config is None:
        config = get_config(args.arch, reduced=args.reduced)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = get_model(config).init(gen, config)
    prefill, decode = build_serve_fns(config)
    launches_before = launch_counts()

    broker = Broker()
    broker.create_topic("requests", partitions=1)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        request = {"id": i,
                   "prompt": rng.integers(0, config.vocab_size,
                                          (args.prompt_len,), dtype=np.int32)}
        if config.family == "audio":
            request["frames"] = rng.standard_normal(
                (config.encoder_seq, config.d_model)).astype(np.float32)
        if config.family == "vlm":
            request["image_embeds"] = rng.standard_normal(
                (config.num_image_tokens, config.d_model)).astype(np.float32)
        broker.produce("requests", request)

    sc = StreamingContext(Context(), broker,
                          max_records_per_partition=args.batch)
    sc.subscribe(["requests"])
    results: dict[int, list[int]] = {}
    prefill_s: list[float] = []
    decode_s: list[float] = []
    ttft_s: list[float] = []
    max_len = args.prompt_len + args.gen
    if config.family == "vlm":
        max_len += config.num_image_tokens

    def on_batch(rdd, info):
        reqs = rdd.collect()
        if not reqs:
            return None
        t0 = time.perf_counter()
        while len(reqs) < args.batch:         # pad the last micro-batch
            reqs.append(reqs[-1])
        batch = {"tokens": torch.from_numpy(
            np.stack([r["prompt"] for r in reqs]).astype(np.int64)).to(dev)}
        for name in {"audio": ("frames",),
                     "vlm": ("image_embeds",)}.get(config.family, ()):
            batch[name] = torch.from_numpy(
                np.stack([r[name] for r in reqs])).to(dev)
        with torch.inference_mode():
            logits, cache = prefill(params, batch, max_len=max_len)
            tokens = logits[:, -1:].argmax(dim=-1)
            tokens[:, 0].cpu()                # waits for the prefill
            t1 = time.perf_counter()
            outs = [tokens[:, 0]]
            for _ in range(args.gen - 1):
                logits, cache = decode(params, tokens, cache)
                tokens = logits[:, -1:].argmax(dim=-1)
                outs.append(tokens[:, 0])
            gen = torch.stack(outs, dim=1).cpu().numpy()
        t2 = time.perf_counter()
        prefill_s.append(t1 - t0)
        decode_s.append(t2 - t1)
        ttft_s.append(t1 - t_start)
        for r, g in zip(reqs, gen):
            results.setdefault(int(r["id"]), list(map(int, g)))
        return len(reqs)

    sc.foreach_batch(on_batch)
    t_start = time.perf_counter()
    while len(results) < args.requests:
        if sc.run_one_batch() is None:
            break
    stream_s = time.perf_counter() - t_start
    # the context stays in the process-wide metrics registry (its gauges'
    # callbacks, the latest context's kept), so it must not keep the batch
    # function, and with it the weights, once the stream is over
    sc.foreach_batch(None)
    n_tok = sum(len(v) for v in results.values())
    after = launch_counts()
    return {"config": config, "device": str(dev), "results": results,
            "tokens": n_tok, "prefill_s": prefill_s, "decode_s": decode_s,
            "ttft_s": ttft_s, "stream_s": stream_s,
            "tokens_per_s": n_tok / stream_s,
            "report": sc.realtime_report(),
            "launches": {k: after[k] - launches_before[k] for k in after}}


def main(argv: list[str] | None = None) -> None:
    res = run_serve(parse_args(argv))
    rep = res["report"]
    log.info("served %d requests, %d tokens in %.2fs (%.1f tok/s; mean "
             "batch %.3fs; first token after %.3fs)", len(res["results"]),
             res["tokens"], res["stream_s"], res["tokens_per_s"],
             rep.get("mean_processing_s", 0.0),
             min(res["ttft_s"], default=0.0))
    log.info("request 0 -> %s", res["results"].get(0, [])[:8])


if __name__ == "__main__":
    main()
