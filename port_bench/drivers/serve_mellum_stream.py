"""Serving Mellum2-12B-A2.5B on the stream, closed loop of waiting clients.

The loop is ``serve_stream``'s, through its helpers (``greedy``,
``sample_ids``): a ``Broker`` topic of requests, a ``StreamingContext``
cutting micro-batches of ``batch`` requests (the last padded with copies
of its last request), ``training.build_serve_fns``' prefill and greedy
decode over the model's cache, ``clients`` clients each sending a prompt
of ``prompt_len`` tokens drawn from the seed and waiting for its ``gen``
tokens before sending the next. The clients start in set-up, whose last
``warmup_batches`` batches are the loop's own. A request's time to first
token runs from its sending to its batch's first tokens on the host.

The program's configuration is the file's published one: its own config
by name, with the file's ``model`` numbers, the attention kind of each of
``layer_types`` and the full layers' yarn from ``rope_parameters``. The
weights are ``reference/mellum2.py``'s draw from the seed, a part at a
time, so that the reference draws them again a layer at a time.

Correct: the logits that picked each served token are kept, and once
the window has closed and the program's state is freed, a sample of the
requests it finished (drawn from the seed, the first and the last among
them), each prompt with its served tokens, runs once through the plain
fp32 reference. Two numbers are compared. ``logit_gap_median`` holds the
program's logits to the reference's: at each served position the RMS of
their difference over the vocabulary, over the RMS of the reference's
logits about their mean (``logit_gaps``), the median over the positions,
which a lower precision moves at every position. ``served_gap``, as
``serve_stream`` reads it, is the widest gap between the reference's best
logit and its logit of the served token, which one wrong token moves.
A median and not the widest logit gap: with random weights the router's
8th and 9th experts lie within rounding of each other, so bf16 routes
some positions differently from fp32 in most layers, and those positions'
logits part by up to a few times the median.
"""
from __future__ import annotations

import time

import numpy as np

from port_bench import bench, loop
from port_bench.drivers.serve_stream import TOPIC, sample_ids
from port_bench.reference import mellum2
from port_bench.reference.decoder import Matmul

KINDS = {"sliding_attention": "sliding", "full_attention": "full"}


def program_config(cfg: dict):
    """The program's config for the file: its own by name, with the
    file's ``model`` numbers, each layer's attention kind and the full
    layers' yarn."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import Yarn

    full = cfg["rope_parameters"]["full_attention"]
    return get_config(cfg["program_config"]).replace(
        **cfg["model"],
        attention_pattern=tuple(KINDS[t] for t in cfg["layer_types"]),
        local_window=cfg["sliding_window"],
        full_rope=Yarn(factor=float(full["factor"]),
                       original_max_position=int(
                           full["original_max_position_embeddings"]),
                       beta_fast=float(full["beta_fast"]),
                       beta_slow=float(full["beta_slow"]),
                       attention_factor=float(full["attention_factor"])))


def to_tree(w: dict, num_layers: int) -> dict:
    """The reference's named leaves as the program's parameter tree."""
    tree: dict = {"embed": {"tok": w["embed.tok"],
                            "lm_head": w["embed.lm_head"]},
                  "layers": [], "final_norm": {"scale": w["final_norm.scale"]}}
    for i in range(num_layers):
        p = f"layers.{i}."
        tree["layers"].append({
            "attn": {k: w[p + "attn." + k] for k in ("wq", "wk", "wv", "wo")},
            "moe": {k: w[p + "moe." + k]
                    for k in ("router", "w_gate", "w_up", "w_down")},
            "norm1": {"scale": w[p + "norm1.scale"]},
            "norm2": {"scale": w[p + "norm2.scale"]}})
    return tree


def greedy(prefill, decode, params, prompts: np.ndarray, gen: int, dev
           ) -> tuple[np.ndarray, float, "torch.Tensor"]:
    """``serve_stream.greedy``'s prefill and greedy decode of one
    micro-batch, keeping the logits: the tokens, when the first of them
    reached the host, and the logits that picked them (B, gen, V) on the
    device."""
    import torch

    batch = {"tokens": torch.from_numpy(prompts.astype(np.int64)).to(dev)}
    with torch.inference_mode():
        logits, cache = prefill(params, batch,
                                max_len=prompts.shape[1] + gen)
        kept = [logits[:, -1]]
        tokens = logits[:, -1:].argmax(dim=-1)
        tokens[:, 0].cpu()                    # waits for the prefill
        first = time.perf_counter()
        outs = [tokens[:, 0]]
        for _ in range(gen - 1):
            logits, cache = decode(params, tokens, cache)
            kept.append(logits[:, -1])
            tokens = logits[:, -1:].argmax(dim=-1)
            outs.append(tokens[:, 0])
        return (torch.stack(outs, dim=1).cpu().numpy(), first,
                torch.stack(kept, dim=1))


def reference_logits(cfg: dict, get, prompts: np.ndarray, served: np.ndarray,
                     device, mm: Matmul):
    """The reference's logits (N, gen, V) at every served position, each
    prompt with its served tokens; all sequences together, so that each
    layer is drawn once."""
    import torch

    P = prompts.shape[1]
    toks = torch.from_numpy(np.concatenate([prompts, served[:, :-1]], axis=1)
                            .astype(np.int64)).to(device)
    return mellum2.logits_at(get, toks, P - 1, cfg, mm)


def logit_gaps(ref, got) -> "torch.Tensor":
    """At each position, ``got``'s RMS gap to the fp32 reference's logits
    ``ref`` over the vocabulary, relative to the RMS of ``ref`` about its
    mean."""
    ref, got = ref.float(), got.to(ref.device).float()
    err = (got - ref).square().mean(-1).sqrt()
    return err / (ref - ref.mean(-1, keepdim=True)).square().mean(-1).sqrt()


def served_gap(ref, tokens) -> float:
    """The widest gap over the positions between the reference's best
    logit and its logit of the token ``tokens`` (N, gen) put there."""
    got = ref.gather(-1, tokens.to(ref.device)[..., None])[..., 0]
    return float((ref.max(-1).values - got).max())


def numbers(ref, got, tokens) -> dict:
    """The compared numbers of logits ``got`` and the tokens ``tokens``
    (N, gen) served from them: the median of ``logit_gaps`` over the
    positions, and ``served_gap``."""
    import torch

    return {"logit_gap_median": float(torch.quantile(
                logit_gaps(ref, got).flatten(), 0.5)),
            "served_gap": served_gap(ref, tokens)}


def alter(gen: np.ndarray, vocab: int) -> None:
    """The fault ``token_altered``: the first request's middle token moved
    to the next in the vocabulary, in place."""
    g = gen.shape[1] // 2
    gen[0, g] = (gen[0, g] + 1) % vocab


def _prompts(vocab: int, P: int, count: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, vocab, (P,), dtype=np.int32)
                     for _ in range(count)])


def control_readings(cfg: dict, traffic: dict, seed: int, device: str
                     ) -> dict:
    """One micro-batch of the seed's prompts served by the program, then
    the compared numbers, each against the fp32 reference: of the
    program's logits and tokens (the program's readings), of the
    reference's own logits in fp8 at the same positions and the tokens
    they put first (the control's), and ``served_gap`` of the program's
    tokens with the first request's middle one altered (the fault
    ``token_altered``; the positions after it keep their served context,
    so this reads the altered token's own gap)."""
    import torch

    from repro_torch.training import build_serve_fns

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    B, P, G = traffic["batch"], traffic["prompt_len"], traffic["gen"]
    prompts = _prompts(cfg["vocab_size"], P, B, seed)
    params = to_tree(mellum2.draw(cfg, seed, dev), cfg["num_hidden_layers"])
    prefill, decode = build_serve_fns(program_config(cfg))
    served, _, logits = greedy(prefill, decode, params, prompts, G, dev)
    logits = logits.cpu()
    del params, prefill, decode
    loop.release(torch)
    get = mellum2.fp32_parts(cfg, seed, dev)
    ref = reference_logits(cfg, get, prompts, served, dev, Matmul())
    fp8 = reference_logits(cfg, get, prompts, served, dev, Matmul(fp8=True))
    tokens = torch.from_numpy(served.astype(np.int64))
    out = {f"{k}.program": v
           for k, v in numbers(ref, logits, tokens).items()}
    out.update({f"{k}.control_fp8": v
                for k, v in numbers(ref, fp8, fp8.argmax(-1)).items()})
    alter(served, cfg["vocab_size"])
    out["served_gap.fault_token_altered"] = served_gap(
        ref, torch.from_numpy(served.astype(np.int64)))
    return out


def run(job: bench.Job) -> dict:
    import torch

    from repro_torch.core.broker import Broker
    from repro_torch.core.dstream import StreamingContext
    from repro_torch.core.rdd import Context
    from repro_torch.data.metrics import get_registry
    from repro_torch.kernels import launch_counts
    from repro_torch.training import build_serve_fns

    cfg, traffic, settings = job.config, job.traffic, job.settings
    dev = torch.device(job.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    B, P, G = traffic["batch"], traffic["prompt_len"], traffic["gen"]
    V, L = cfg["vocab_size"], cfg["num_hidden_layers"]
    config = program_config(cfg)
    params = to_tree(mellum2.draw(cfg, job.seed, dev), L)
    prefill, decode = build_serve_fns(config)

    broker = Broker()
    broker.create_topic(TOPIC, partitions=1)
    sc = StreamingContext(Context(), broker, max_records_per_partition=B)
    sc.subscribe([TOPIC])
    rng = np.random.default_rng(job.seed)
    prompts: dict[int, np.ndarray] = {}
    sent: dict[int, float] = {}
    results: dict[int, np.ndarray] = {}
    kept: dict = {}                         # each request's logits
    ttft: dict[int, float] = {}
    prefill_s: list[float] = []
    decode_s: list[float] = []

    def send() -> None:
        r = len(prompts)
        prompts[r] = rng.integers(0, V, (P,), dtype=np.int32)
        broker.produce(TOPIC, {"id": r, "prompt": prompts[r]})
        sent[r] = time.perf_counter()

    def on_batch(rdd, info):
        reqs = rdd.collect()
        if not reqs:
            return None
        n = len(reqs)
        t0 = time.perf_counter()
        padded = list(reqs) + [reqs[-1]] * (B - n)
        gen, t1, logits = greedy(prefill, decode, params,
                                 np.stack([r["prompt"] for r in padded]),
                                 G, dev)
        prefill_s.append(t1 - t0)
        decode_s.append(time.perf_counter() - t1)
        if job.fault == "token_altered":     # the harness's own tests
            alter(gen, V)
        for r, g, z in zip(reqs, gen[:n], logits):
            results[int(r["id"])] = g
            kept[int(r["id"])] = z
            ttft[int(r["id"])] = t1 - sent[int(r["id"])]
        return n

    sc.foreach_batch(on_batch)

    def unit() -> int:
        before = len(results)
        sc.run_one_batch()
        for _ in range(len(results) - before):   # each reply's client
            send()
        return (len(results) - before) * G

    for _ in range(traffic["clients"]):
        send()
    for _ in range(traffic["warmup_batches"]):
        unit()
    before = set(results)
    kept.clear()
    prefill_s.clear()
    decode_s.clear()
    rec: dict = {"setup_s": time.perf_counter() - job.t_start}
    window_s, tokens, batches = loop.window(unit, job.seconds)
    done = sorted(set(results) - before)
    rec.update(window_s=window_s, served_tokens=int(tokens),
               ttft_s=[ttft[r] for r in done], window_units=batches,
               prefill_s=list(prefill_s), decode_s=list(decode_s),
               decode_steps=batches * (G - 1), batch=B, prompt_len=P,
               gen=G, model=dict(cfg["model"]))
    if job.trace and dev.type == "cuda":
        rows = get_registry().counter("moe_rows_total")
        rows_before = rows.value()
        rec["trace"] = loop.traced(
            unit, settings["trace_batches"],
            {"flash_attention": ("repro_torch.kernels.flash_attention.ops",
                                 "flash_attention"),
             "blocked_attention": ("repro_torch.models.attention",
                                   "blocked_attention")},
            launched=lambda: launch_counts()["flash_attention"])
        bench.log(f"serve: the program's moe_rows_total over the trace "
                  f"{rows.value() - rows_before:.0f}")
    rec["device"] = bench.device_info(torch, job.device)
    sc.foreach_batch(None)
    ids = sample_ids(done, traffic["sample_requests"], job.seed)
    logits = torch.stack([kept[r] for r in ids]).cpu()
    del params, sc, broker, prefill, decode, kept
    loop.release(torch)

    served = np.stack([results[r] for r in ids])
    ref = reference_logits(cfg, mellum2.fp32_parts(cfg, job.seed, dev),
                           np.stack([prompts[r] for r in ids]), served, dev,
                           Matmul())
    limits = settings["limits"]
    rec["checks"] = [{"name": k, "value": v, "limit": limits[k]}
                     for k, v in numbers(
                         ref, logits,
                         torch.from_numpy(served.astype(np.int64))).items()]
    bench.log(f"serve: prefill s {np.round(rec['prefill_s'], 4).tolist()}; "
              f"decode s {np.round(rec['decode_s'], 4).tolist()}; ttft p50 "
              f"{np.percentile(rec['ttft_s'], 50):.4f} max "
              f"{max(rec['ttft_s']):.4f}")
    bench.log(f"serve: {len(done)} requests in {window_s:.3f} s, "
              f"{len(ids)} sampled, {len(ids) * G} served tokens compared")
    rec["correct"] = all(c["value"] <= c["limit"] for c in rec["checks"])
    rec["attempted"], rec["failed"] = len(done), 0
    return rec
