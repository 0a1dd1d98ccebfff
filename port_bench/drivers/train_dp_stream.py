"""Data-parallel training on the stream over ``ranks`` processes, a step a
micro-batch on every rank, closed loop.

Each rank is a process of its own, started by the run's process, which
waits for them up to ``deadline_s`` past the window's length (set-up,
trace and reference included), then kills them and fails the run; a
rank that fails ends the run at once. A rank joins a ``torch.distributed`` group (NCCL with
one card a rank on the card, gloo on the CPU) at a free ``localhost``
port, and drives ``parallel/dp.py:build_dp_train_step``'s plain step
(no compression) from the program's own parts: a ``Broker`` topic of
token rows of its own (drawn from the seed and its rank, every row new,
``queued_batches`` micro-batches kept waiting), a ``StreamingContext``
cutting micro-batches of ``batch`` rows, the program's ``assemble_batch``,
on a state of the benchmark's weights (``reference/weights.py``) and
``init_dp_opt_state``'s shards. Rank 0 leads: before each step of the
window and the trace it broadcasts whether the others take one more, so
that every rank runs as many steps as it. A step's tokens are all the
ranks' rows; the window is rank 0's, ending at the first step boundary at
or after its length, each step ending with its loss on the host.

Correct: the first ``checked_steps`` steps of set-up, the window's own
state, call and feed, against the plain reference's fp32 AdamW steps
(``reference/decoder.py``) over the same rows, the ranks' rows of a step
in rank order, from the same weights, with weight decay on every leaf,
as the DP step decays its whole flat vector: each step's loss (the ranks'
mean), each leaf's clipped step-1 gradient norm (``‖m‖ / (1 - b1)``, each
leaf's squares summed over the ranks' shards of ``m``) and each leaf's
change over the steps (the shards of the fp32 master against the drawn
weights), compared as ``train_stream`` compares them. Rank 0 runs the
reference after the others have left.
"""
from __future__ import annotations

import itertools
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np

from port_bench import bench, loop, spanlog
from port_bench.drivers.train_stream import (compare, named, optimizer,
                                             program_config, to_tree,
                                             worst_leaves)
from port_bench.reference import decoder, weights

TOPIC = "tokens"
RANK_MAIN = """
import sys
from pathlib import Path
sys.path[:0] = [{root!r}, {src!r}]
from port_bench import bench
bench.load_module(Path({path!r}), "port_bench_rank").rank_main(
    {job!r}, int(sys.argv[1]))
"""


def rank_rows(seed: int, rank: int, seq: int, vocab: int):
    """Rank ``rank``'s token rows of ``seq`` from the seed (int32), without
    end."""
    rng = np.random.default_rng([seed, rank])
    while True:
        yield rng.integers(0, vocab, (seq,), dtype=np.int32)


def checked_rows(seed: int, traffic: dict, vocab: int) -> np.ndarray:
    """The checked steps' global batches, (steps · ranks · batch, seq):
    each step's rows, the ranks' in rank order."""
    W, B, S = traffic["ranks"], traffic["batch"], traffic["seq"]
    per = [list(itertools.islice(rank_rows(seed, r, S, vocab),
                                 traffic["checked_steps"] * B))
           for r in range(W)]
    return np.stack([row for step in range(traffic["checked_steps"])
                     for r in range(W) for row in per[r][step * B:
                                                         (step + 1) * B]])


def reference_run(cfg: dict, traffic: dict, seed: int, rows: np.ndarray,
                  device, fp8: bool = False, rows_used: int | None = None
                  ) -> dict:
    """The plain reference's checked steps from the seed's weights, a
    global batch of ``ranks · batch`` rows a step, every leaf decayed."""
    import torch

    n = traffic["ranks"] * traffic["batch"]
    w0 = weights.draw(cfg["model"], seed, device)
    batches = [torch.from_numpy(rows[i * n:(i + 1) * n][:rows_used]
                                .astype(np.int64)).to(device)
               for i in range(traffic["checked_steps"])]
    return decoder.train(w0, batches, cfg["model"], optimizer(traffic),
                         decoder.Matmul(fp8=fp8), lambda name: True)


def reference_no_exchange(cfg: dict, traffic: dict, seed: int,
                          rows: np.ndarray, device) -> dict:
    """The fault of the exchange left out, in the reference: each rank's
    shard of the flat vector (the program's leaves in its order, cut in
    ``ranks`` equal chunks) moved by that rank's own rows' gradient over
    the ranks, the local chunk in place of the reduce-scatter's sum,
    clipped by those chunks' norm together; fp32 AdamW as
    ``decoder.train``'s, every leaf decayed. The loss is the ranks' mean."""
    import math

    import torch

    from repro_torch.utils import tree_leaves

    m, W, B = cfg["model"], traffic["ranks"], traffic["batch"]
    opt = optimizer(traffic)
    w0 = weights.draw(m, seed, device)
    tree = to_tree(w0, m["num_layers"])
    names = {id(t): n for n, t in named(tree, m["num_layers"]).items()}
    order = [names[id(t)] for t in tree_leaves(tree)]
    chunk = -(-sum(w0[n].numel() for n in order) // W)
    params = {n: w0[n].float().requires_grad_() for n in order}
    mom = {n: torch.zeros_like(p) for n, p in params.items()}
    var = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    losses, first = [], {}
    for step in range(1, traffic["checked_steps"] + 1):
        g = {n: torch.empty_like(p) for n, p in params.items()}
        step_rows = rows[(step - 1) * W * B:step * W * B]
        local = []
        for r in range(W):
            toks = torch.from_numpy(step_rows[r * B:(r + 1) * B]
                                    .astype(np.int64)).to(device)
            value = decoder.loss(params, toks, m, decoder.Matmul())
            grads = torch.autograd.grad(value, list(params.values()))
            local.append(float(value.detach()))
            at = 0
            for n, gr in zip(order, grads):
                lo = max(at, r * chunk) - at
                hi = min(at + gr.numel(), (r + 1) * chunk) - at
                if lo < hi:
                    g[n].view(-1)[lo:hi] = gr.reshape(-1)[lo:hi] / W
                at += gr.numel()
            del grads
        losses.append(sum(local) / W)
        gnorm = math.sqrt(sum(float(t.double().square().sum())
                              for t in g.values()))
        scale = min(1.0, opt["grad_clip"] / max(gnorm, 1e-9))
        lr = decoder.lr_at(step, opt)
        with torch.no_grad():
            for n, p in params.items():
                gn = g[n] * scale
                if step == 1:
                    first[n] = float(torch.linalg.vector_norm(gn))
                mom[n].mul_(b1).add_(gn, alpha=1 - b1)
                var[n].mul_(b2).add_(gn.square(), alpha=1 - b2)
                delta = (mom[n] / (1 - b1 ** step)) / (
                    torch.sqrt(var[n] / (1 - b2 ** step)) + eps)
                p.sub_(lr * (delta + opt["weight_decay"] * p))
        del g
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(p - w0[n].float()))
                  for n, p in params.items()}
    return {"losses": losses, "grad_norms": first, "changes": change}


def control_readings(cfg: dict, traffic: dict, seed: int, device: str
                     ) -> dict:
    """The control (the reference in fp8) and two faults, each in the
    program's place, against the reference, at the cell's global batch,
    on one card: half of every step's rows left out, and the exchange
    between the ranks left out (``reference_no_exchange``)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    rows = checked_rows(seed, traffic, cfg["model"]["vocab_size"])
    want = reference_run(cfg, traffic, seed, rows, dev)
    n = traffic["ranks"] * traffic["batch"]
    out = {}
    for name, got in (
            ("control_fp8", lambda: reference_run(cfg, traffic, seed, rows,
                                                  dev, fp8=True)),
            ("fault_half_batch", lambda: reference_run(
                cfg, traffic, seed, rows, dev, rows_used=n // 2)),
            ("fault_no_exchange", lambda: reference_no_exchange(
                cfg, traffic, seed, rows, dev))):
        gaps = compare(got(), want, traffic["zero_grad_rule"])
        out.update({f"{k}.{name}": v for k, v in gaps.items()})
    out["losses.reference"] = want["losses"]
    return out


# -- the run's process -------------------------------------------------------------
def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(job: bench.Job) -> dict:
    """Start the ranks, wait for them up to the deadline, return rank 0's
    record."""
    W = job.traffic["ranks"]
    with tempfile.TemporaryDirectory(prefix="train_dp_") as tmp:
        spec = {"root": str(job.root), "config": job.config,
                "traffic": job.traffic, "settings": job.settings,
                "seed": job.seed, "seconds": job.seconds,
                "trace": job.trace, "device": job.device,
                "t_start": job.t_start, "fault": job.fault,
                "port": _free_port(), "out": os.path.join(tmp, "rec.json")}
        job_path = os.path.join(tmp, "job.json")
        Path(job_path).write_text(json.dumps(spec))
        code = RANK_MAIN.format(root=str(job.root),
                                src=str(job.root / "src"),
                                path=str(Path(__file__).resolve()),
                                job=job_path)
        # the ranks' output to standard error: the run's last line on
        # standard output is its result; one intra-op thread a rank unless
        # set, as torchrun starts its workers
        env = {"OMP_NUM_THREADS": "1", **os.environ}
        procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                                  cwd=job.root, stdout=2, env=env)
                 for r in range(W)]
        deadline = time.monotonic() + job.seconds + job.traffic["deadline_s"]
        fault = None
        while fault is None:
            codes = [p.poll() for p in procs]
            bad = [(r, rc) for r, rc in enumerate(codes) if rc not in (None, 0)]
            if bad:
                fault = f"rank {bad[0][0]} of {W} exited with {bad[0][1]}"
            elif None not in codes:
                break
            elif time.monotonic() > deadline:
                fault = (f"the ranks passed the deadline of "
                         f"{job.traffic['deadline_s']} s after the window")
            else:
                time.sleep(0.2)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if fault:
            raise bench.BenchError(fault)
        return json.loads(Path(spec["out"]).read_text())


# -- one rank ----------------------------------------------------------------------
def _leaf_squares(vec, lo: int, spans: list[tuple[int, int]]) -> list[float]:
    """Each leaf's sum of squares over the part of it that the flat shard
    ``vec`` (starting at ``lo`` of the flat vector) holds."""
    hi = lo + vec.numel()
    out = []
    for a, b in spans:
        a2, b2 = max(a, lo), min(b, hi)
        out.append(float(vec[a2 - lo:b2 - lo].double().square().sum())
                   if a2 < b2 else 0.0)
    return out


def rank_main(job_path: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.core.broker import Broker
    from repro_torch.core.dstream import StreamingContext
    from repro_torch.core.rdd import Context
    from repro_torch.data.metrics import recent_batches
    from repro_torch.launch.train import assemble_batch
    from repro_torch.parallel.dp import build_dp_train_step, \
        init_dp_opt_state
    from repro_torch.utils import tree_leaves

    spec = json.loads(Path(job_path).read_text())
    cfg, traffic, settings = spec["config"], spec["traffic"], \
        spec["settings"]
    W, B, S = traffic["ranks"], traffic["batch"], traffic["seq"]
    m = cfg["model"]
    cuda = spec["device"].startswith("cuda")
    if cuda:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{spec['port']}",
                            world_size=W, rank=rank,
                            timeout=timedelta(seconds=traffic["deadline_s"]))
    group = dist.group.WORLD
    config = program_config(cfg)
    opt_cfg = OptimizerConfig(**optimizer(traffic), zero1=False)

    w0 = weights.draw(m, spec["seed"], dev)
    params = to_tree(w0, m["num_layers"])
    names = {id(t): n for n, t in named(params, m["num_layers"]).items()}
    order = [names[id(t)] for t in tree_leaves(params)]
    spans, at = [], 0
    for t in tree_leaves(params):
        spans.append((at, at + t.numel()))
        at += t.numel()
    holder = {"state": {"params": params,
                        "opt": init_dp_opt_state(params, group, opt_cfg)}}
    del params
    step_fn = build_dp_train_step(config, opt_cfg, group)
    if spec["fault"] == "no_exchange":            # the harness's own tests
        from repro_torch.parallel import dp
        dp._Wire.reduce_scatter = lambda self, x2d: x2d[self.rank].clone()
    if spec["fault"] == "state_unchanged":
        def step_fn(state, batch, _fn=step_fn):
            import copy
            _, metrics = _fn(copy.deepcopy(state), batch)
            return state, metrics

    broker = Broker()
    broker.create_topic(TOPIC, partitions=1)
    sc = StreamingContext(Context(), broker, max_records_per_partition=B)
    sc.subscribe([TOPIC])
    losses: list[float] = []

    def on_batch(rdd, info):
        records = rdd.collect()[:B]
        if len(records) < B:
            return None
        batch = assemble_batch(records, config, dev)
        holder["state"], metrics = step_fn(holder["state"], batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        return loss

    sc.foreach_batch(on_batch)
    stream = rank_rows(spec["seed"], rank, S, m["vocab_size"])

    def step() -> int:
        while sc.lag(TOPIC) < traffic["queued_batches"] * B:
            broker.produce(TOPIC, {"tokens": next(stream)})
        sc.run_one_batch()
        return W * B * S

    flag = torch.zeros(1, dtype=torch.int32, device=dev)

    def go(value: int = 0) -> int:
        """Rank 0's word to every rank: 1 one more step, 0 stop."""
        flag.fill_(value)
        dist.broadcast(flag, src=0, group=group)
        return int(flag.item())

    def shard_norms(vec, scale: float = 1.0) -> dict:
        """Each leaf's norm over every rank's shard of a flat vector."""
        lo = rank * vec.numel()
        sq = torch.tensor(_leaf_squares(vec, lo, spans), dtype=torch.float64,
                          device=dev)
        dist.all_reduce(sq, group=group)
        return {n: float(v) ** 0.5 * scale for n, v in zip(order, sq.tolist())}

    prog: dict = {}
    step()
    prog["grad_norms"] = shard_norms(holder["state"]["opt"]["m"],
                                     1.0 / (1.0 - opt_cfg.b1))
    for _ in range(traffic["checked_steps"] - 1):
        step()
    # the drawn weights' part of this rank's shard (the params, views of
    # the first draw, have moved)
    master = holder["state"]["opt"]["master"]
    lo = rank * master.numel()
    del w0
    w0 = weights.draw(m, spec["seed"], dev)
    start = torch.zeros_like(master)
    for n, (a, b) in zip(order, spans):
        a2, b2 = max(a, lo), min(b, lo + master.numel())
        if a2 < b2:
            start[a2 - lo:b2 - lo] = w0[n].reshape(-1)[a2 - a:b2 - a]
    del w0
    prog["changes"] = shard_norms(master - start)
    del start, master
    prog["losses"] = list(losses[:traffic["checked_steps"]])

    if rank:
        while go():
            step()
        sc.foreach_batch(None)
        dist.destroy_process_group()
        return

    step_s: list[float] = []

    def unit() -> int:
        t0 = time.perf_counter()
        go(1)
        done = step()
        step_s.append(time.perf_counter() - t0)
        return done

    rec: dict = {"setup_s": time.perf_counter() - spec["t_start"]}
    window_s, tokens, steps = loop.window(unit, spec["seconds"])
    bench.log(f"train_dp: window steps s quartiles "
              f"{np.round(np.percentile(step_s, [0, 25, 50, 75, 100]), 4).tolist()}")
    rec.update(window_s=window_s, train_tokens=int(tokens), steps=steps,
               window_units=steps, batch=W * B, seq=S, ranks=W, model=m)
    if spec["trace"] and cuda:
        rec["trace"] = loop.traced(unit, settings["trace_steps"], {
            "attention": ("repro_torch.models.attention",
                          "blocked_attention")})
    go(0)
    device = bench.device_info(torch, spec["device"])
    device["count"] = W
    rec["device"] = device
    rec["spans"] = [{"traced": b["traced"], "spans": [
        s for s in b["spans"] if s["name"].startswith("dp_")]}
        for b in recent_batches()]
    coll = [sum(s["device_s"] or 0.0 for s in b["spans"])
            for b in spanlog.window(rec, rec["spans"])]
    if coll:
        bench.log(f"train_dp: collectives ms a window step, quartiles "
                  f"{np.round(1e3 * np.percentile(coll, [0, 25, 50, 75, 100]), 2).tolist()}")
    sc.foreach_batch(None)
    dist.destroy_process_group()
    del holder, step_fn, sc, broker
    loop.release(torch)

    rows = checked_rows(spec["seed"], traffic, m["vocab_size"])
    refr = reference_run(cfg, traffic, spec["seed"], rows, dev)
    gaps = compare(prog, refr, traffic["zero_grad_rule"])
    limits = settings["limits"]
    rec["checks"] = [{"name": k, "value": v, "limit": limits[k]}
                     for k, v in gaps.items() if k in limits]
    bench.log(f"train_dp: {W} ranks; losses {prog['losses']} against the "
              f"reference's {refr['losses']}; numbers {gaps}")
    bench.log(f"train_dp: worst gradient leaves "
              f"{worst_leaves(prog['grad_norms'], refr['grad_norms'])}; "
              f"worst change leaves "
              f"{worst_leaves(prog['changes'], refr['changes'])}")
    rec["correct"] = all(c["value"] <= c["limit"] for c in rec["checks"])
    rec["attempted"], rec["failed"] = steps, 0
    Path(spec["out"]).write_text(json.dumps(rec))
