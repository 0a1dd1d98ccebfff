"""Serving on the stream, closed loop of waiting clients.

The window drives ``launch/serve.py:run_serve``'s ``on_batch`` from the
program's own parts: a ``Broker`` topic of requests, a
``StreamingContext`` cutting micro-batches of ``batch`` requests (the last
padded with copies of its last request, as ``run_serve`` pads it), and
``training.build_serve_fns``' prefill and greedy decode over the KV cache.
The benchmark adds the clients, the loop and the timing: ``clients``
clients each send a request and wait for its reply before sending the
next, every prompt of one fixed length drawn from the seed in the order
the requests are sent. The clients start in set-up, whose last
``warmup_batches`` batches are the loop's own, so that the window begins
in the loop's steady state; the window counts every request completed in
it. A request's time to first token runs from its sending to its batch's
first tokens on the host.

Correct: once the window has closed, a sample of the requests it finished
(drawn from the seed, the first and the last among them), each prompt
with its served tokens run once through the plain fp32 reference
(``reference/decoder.py``) from the seed's weights: the widest gap by
which a served token's reference logit lies below the reference's best
at its position.
"""
from __future__ import annotations

import time

import numpy as np

from port_bench import bench, loop
from port_bench.drivers.train_stream import program_config, to_tree
from port_bench.reference import decoder, weights

TOPIC = "requests"


def sample_ids(done: list[int], count: int, seed: int) -> list[int]:
    """``count`` of the finished requests, drawn from the seed, the first
    and the last always among them."""
    rng = np.random.default_rng(seed)
    rest = done[1:-1]
    pick = rng.choice(len(rest), size=min(max(count - 2, 0), len(rest)),
                      replace=False) if rest else []
    return sorted({done[0], done[-1], *(rest[i] for i in pick)})


def widest_gap(m: dict, w: dict, prompts: np.ndarray, served: np.ndarray,
               device, mm: "decoder.Matmul", chosen: str = "served",
               chunk: int = 8) -> float:
    """The widest gap over every served position between the reference's
    best logit and its logit of the token: the served token, or with
    ``chosen="own"`` the token ``mm``'s own logits put first (the
    control's reading, where ``mm`` is the lower precision)."""
    import torch

    exact = decoder.Matmul()
    P = prompts.shape[1]
    gap = 0.0
    for a in range(0, len(prompts), chunk):
        toks = torch.from_numpy(np.concatenate(
            [prompts[a:a + chunk], served[a:a + chunk, :-1]], axis=1)
            .astype(np.int64)).to(device)
        ref = decoder.logits_at(w, toks, P - 1, m, exact)
        if chosen == "served":
            pick = torch.from_numpy(served[a:a + chunk].astype(np.int64)
                                    ).to(device)
        else:
            pick = decoder.logits_at(w, toks, P - 1, m, mm).argmax(-1)
        got = ref.gather(-1, pick[..., None])[..., 0]
        gap = max(gap, float((ref.max(-1).values - got).max()))
    return gap


def fp32_weights(m: dict, seed: int, device) -> dict:
    return {n: t.float() for n, t in weights.draw(m, seed, device).items()}


def control_readings(cfg: dict, traffic: dict, seed: int, device: str
                     ) -> dict:
    """One micro-batch of the seed's prompts served by the program, then
    the widest gap of its served tokens (the program's reading) and of the
    tokens the reference in fp8 puts first at the same positions (the
    control's), both against the fp32 reference."""
    import torch

    from repro_torch.training import build_serve_fns

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    m, B = cfg["model"], traffic["batch"]
    P, G = traffic["prompt_len"], traffic["gen"]
    rng = np.random.default_rng(seed)
    prompts = np.stack([rng.integers(0, m["vocab_size"], (P,),
                                     dtype=np.int32) for _ in range(B)])
    params = to_tree(weights.draw(m, seed, dev), m["num_layers"])
    prefill, decode = build_serve_fns(program_config(cfg))
    served, _ = greedy(prefill, decode, params, prompts, G, dev)
    del params
    w = fp32_weights(m, seed, dev)
    return {"served_gap.program": widest_gap(
                m, w, prompts, served, dev, decoder.Matmul()),
            "served_gap.control_fp8": widest_gap(
                m, w, prompts, served, dev, decoder.Matmul(fp8=True),
                chosen="own")}


def greedy(prefill, decode, params, prompts: np.ndarray, gen: int, dev
           ) -> tuple[np.ndarray, float]:
    """``run_serve``'s prefill and greedy decode of one micro-batch: the
    tokens, and when the first of them reached the host."""
    import torch

    batch = {"tokens": torch.from_numpy(prompts.astype(np.int64)).to(dev)}
    with torch.inference_mode():
        logits, cache = prefill(params, batch,
                                max_len=prompts.shape[1] + gen)
        tokens = logits[:, -1:].argmax(dim=-1)
        tokens[:, 0].cpu()                    # waits for the prefill
        first = time.perf_counter()
        outs = [tokens[:, 0]]
        for _ in range(gen - 1):
            logits, cache = decode(params, tokens, cache)
            tokens = logits[:, -1:].argmax(dim=-1)
            outs.append(tokens[:, 0])
        return torch.stack(outs, dim=1).cpu().numpy(), first


def run(job: bench.Job) -> dict:
    import torch

    from repro_torch.core.broker import Broker
    from repro_torch.core.dstream import StreamingContext
    from repro_torch.core.rdd import Context
    from repro_torch.kernels import launch_counts
    from repro_torch.training import build_serve_fns

    cfg, traffic, settings = job.config, job.traffic, job.settings
    dev = torch.device(job.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    m, B = cfg["model"], traffic["batch"]
    P, G = traffic["prompt_len"], traffic["gen"]
    config = program_config(cfg)
    params = to_tree(weights.draw(m, job.seed, dev), m["num_layers"])
    prefill, decode = build_serve_fns(config)

    broker = Broker()
    broker.create_topic(TOPIC, partitions=1)
    sc = StreamingContext(Context(), broker, max_records_per_partition=B)
    sc.subscribe([TOPIC])
    rng = np.random.default_rng(job.seed)
    prompts: dict[int, np.ndarray] = {}
    sent: dict[int, float] = {}
    results: dict[int, np.ndarray] = {}
    ttft: dict[int, float] = {}
    prefill_s: list[float] = []
    decode_s: list[float] = []

    def send() -> None:
        r = len(prompts)
        prompts[r] = rng.integers(0, m["vocab_size"], (P,), dtype=np.int32)
        broker.produce(TOPIC, {"id": r, "prompt": prompts[r]})
        sent[r] = time.perf_counter()

    def serve(reqs: list[dict]) -> tuple[np.ndarray, float]:
        # launch/serve.py:run_serve's on_batch
        t0 = time.perf_counter()
        while len(reqs) < B:                  # pad the last micro-batch
            reqs.append(reqs[-1])
        gen, t1 = greedy(prefill, decode, params,
                         np.stack([r["prompt"] for r in reqs]), G, dev)
        prefill_s.append(t1 - t0)
        decode_s.append(time.perf_counter() - t1)
        return gen, t1

    def on_batch(rdd, info):
        reqs = rdd.collect()
        if not reqs:
            return None
        n = len(reqs)
        gen, t1 = serve(list(reqs))
        if job.fault == "token_altered":     # the harness's own tests
            gen[0, G // 2] = (gen[0, G // 2] + 1) % m["vocab_size"]
        for r, g in zip(reqs[:n], gen[:n]):
            results[int(r["id"])] = g
            ttft[int(r["id"])] = t1 - sent[int(r["id"])]
        return n

    sc.foreach_batch(on_batch)

    def unit() -> int:
        before = len(results)
        sc.run_one_batch()
        for _ in range(len(results) - before):   # each reply's client
            send()
        return (len(results) - before) * G

    # the clients start in set-up: the loop's first batches are its
    # warm-up, so that the window finds it steady
    for _ in range(traffic["clients"]):
        send()
    for _ in range(traffic["warmup_batches"]):
        unit()
    before = set(results)
    prefill_s.clear()
    decode_s.clear()
    rec: dict = {"setup_s": time.perf_counter() - job.t_start}
    window_s, tokens, batches = loop.window(unit, job.seconds)
    done = sorted(set(results) - before)
    rec.update(window_s=window_s, served_tokens=int(tokens),
               ttft_s=[ttft[r] for r in done], window_units=batches,
               prefill_s=list(prefill_s), decode_s=list(decode_s),
               decode_steps=batches * (G - 1), batch=B, prompt_len=P,
               model=m)
    if job.trace and dev.type == "cuda":
        rec["trace"] = loop.traced(
            unit, settings["trace_batches"],
            {"flash_attention": ("repro_torch.kernels.flash_attention.ops",
                                 "flash_attention")},
            launched=lambda: launch_counts()["flash_attention"])
    rec["device"] = bench.device_info(torch, job.device)
    sc.foreach_batch(None)
    del params, sc, broker
    loop.release(torch)

    ids = sample_ids(done, traffic["sample_requests"], job.seed)
    w = fp32_weights(m, job.seed, dev)
    gap = widest_gap(m, w, np.stack([prompts[r] for r in ids]),
                     np.stack([results[r] for r in ids]), dev,
                     decoder.Matmul())
    limit = settings["limits"]["served_gap"]
    rec["checks"] = [{"name": "served_gap", "value": gap, "limit": limit}]
    batch_s = [a + b for a, b in zip(rec["prefill_s"], rec["decode_s"])]
    bench.log(f"serve: batch s {np.round(batch_s, 4).tolist()}; prefill s "
            f"{np.round(rec['prefill_s'], 4).tolist()}; ttft p50 "
            f"{np.percentile(rec['ttft_s'], 50):.4f} p90 "
            f"{np.percentile(rec['ttft_s'], 90):.4f} max "
            f"{max(rec['ttft_s']):.4f}")
    bench.log(f"serve: {len(done)} requests in {window_s:.3f} s, "
            f"{len(ids)} sampled, {len(ids) * G} served tokens compared")
    rec["correct"] = gap <= limit
    rec["attempted"], rec["failed"] = len(done), 0
    return rec
