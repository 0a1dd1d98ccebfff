"""Training on the stream, a step a micro-batch, closed loop.

The window drives ``launch/train.py:run_train``'s loop without its
checkpoints, from the program's own parts: a ``Broker`` topic of token
rows, a ``StreamingContext`` cutting micro-batches of ``batch`` rows, the
program's ``assemble_batch``, and ``training.build_train_step``'s step on a
state of the benchmark's weights and ``optim.init_opt_state``. Each step
ends with its loss on the host. The benchmark adds the producer (rows
drawn from the seed, every row new, ``queued_batches`` micro-batches kept
waiting), the loop and the timing.

Set-up builds the one state, drives it from the seed through its first
``checked_steps`` steps through the window's own call and feed, and hands
the same state to the window. Correct: those steps against the plain
reference's (``reference/decoder.py``), from the same weights on the same
rows: each step's loss, each leaf's clipped gradient norm at step 1 (the
program's, ``‖m‖ / (1 - b1)`` from its optimizer state after one step),
and each leaf's change over the steps, each a gap of norms taken by the
worst leaf against the larger of that leaf's reference norm and the
median leaf's.
"""
from __future__ import annotations

import itertools
import statistics
import time

import numpy as np

from port_bench import bench, loop
from port_bench.reference import decoder, weights

TOPIC = "tokens"


def program_config(cfg: dict):
    """The program's config for the file's model: its own config by name,
    with every number the file states."""
    from repro_torch.configs import get_config

    return get_config(cfg["program_config"]).replace(**cfg["model"])


def optimizer(traffic: dict) -> dict:
    return {k: traffic["optimizer"][k] for k in (
        "lr", "warmup_steps", "total_steps", "b1", "b2", "eps",
        "weight_decay", "grad_clip")}


def rows(seed: int, seq: int, vocab: int):
    """Token rows of ``seq`` from the seed, uniform over the vocabulary
    (int32, as the program's producer draws them), without end."""
    rng = np.random.default_rng(seed)
    while True:
        yield rng.integers(0, vocab, (seq,), dtype=np.int32)


def to_tree(w: dict, num_layers: int) -> dict:
    """The benchmark's named leaves as the program's parameter tree."""
    tree: dict = {"embed": {"tok": w["embed.tok"],
                            "lm_head": w["embed.lm_head"]},
                  "layers": [], "final_norm": {"scale": w["final_norm.scale"]}}
    for i in range(num_layers):
        p = f"layers.{i}."
        tree["layers"].append({
            "attn": {k: w[p + "attn." + k] for k in ("wq", "wk", "wv", "wo")},
            "mlp": {k: w[p + "mlp." + k]
                    for k in ("w_up", "w_down", "w_gate")},
            "norm1": {"scale": w[p + "norm1.scale"]},
            "norm2": {"scale": w[p + "norm2.scale"]}})
    return tree


def named(tree: dict, num_layers: int) -> dict:
    """The program's tree back as the benchmark's names."""
    out = {"embed.tok": tree["embed"]["tok"],
           "embed.lm_head": tree["embed"]["lm_head"],
           "final_norm.scale": tree["final_norm"]["scale"]}
    for i, layer in enumerate(tree["layers"][:num_layers]):
        for group, leaves in layer.items():
            for k, t in leaves.items():
                out[f"layers.{i}.{group}.{k}"] = t
    return out


def leaf_gaps(got: dict, want: dict, leaves=None) -> dict:
    """Each leaf's |‖got‖ - ‖want‖| over the larger of its ‖want‖ and the
    median leaf's."""
    leaves = list(want) if leaves is None else leaves
    med = statistics.median(want[n] for n in leaves)
    return {n: abs(got[n] - want[n]) / max(want[n], med) for n in leaves}


def norm_gap(got: dict, want: dict, leaves=None) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(got, want, leaves).values())


def worst_leaves(got: dict, want: dict, count: int = 3) -> str:
    gaps = leaf_gaps(got, want)
    top = sorted(gaps, key=gaps.get, reverse=True)[:count]
    return (", ".join(f"{n} {gaps[n]:.3g}" for n in top)
            + f"; median leaf {statistics.median(gaps.values()):.3g}")


def compare(prog: dict, refr: dict, zero_rule: float) -> dict:
    """The numbers compared: the worst step's loss gap (relative), the
    worst leaf's first-gradient gap and change gap. Leaves whose
    reference gradient is under ``zero_rule`` of the median leaf's move
    by round-off alone and are left out of the change."""
    med = statistics.median(refr["grad_norms"].values())
    moving = [n for n, g in refr["grad_norms"].items()
              if g >= zero_rule * med]
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(prog["losses"], refr["losses"])),
            "grad_gap": norm_gap(prog["grad_norms"], refr["grad_norms"]),
            "change_gap": norm_gap(prog["changes"], refr["changes"],
                                   moving)}


def reference_run(cfg: dict, traffic: dict, seed: int, checked: np.ndarray,
                  device, fp8: bool = False, rows_used: int | None = None
                  ) -> dict:
    """The plain reference's checked steps from the seed's weights, on the
    ``checked`` rows, ``batch`` a step."""
    import torch

    m, B = cfg["model"], traffic["batch"]
    w0 = weights.draw(m, seed, device)
    batches = [torch.from_numpy(checked[i * B:(i + 1) * B][:rows_used]
                                .astype(np.int64)).to(device)
               for i in range(traffic["checked_steps"])]
    return decoder.train(w0, batches, m, optimizer(traffic),
                         decoder.Matmul(fp8=fp8), weights.decays)


def control_readings(cfg: dict, traffic: dict, seed: int, device: str
                     ) -> dict:
    """The control (the reference in fp8) and the fault of half the batch
    left out (the mean over the rest), each in the program's place,
    against the reference."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    B, S = traffic["batch"], traffic["seq"]
    checked = np.stack(list(itertools.islice(
        rows(seed, S, cfg["model"]["vocab_size"]),
        traffic["checked_steps"] * B)))
    want = reference_run(cfg, traffic, seed, checked, dev)
    out = {}
    for name, kw in (("control_fp8", {"fp8": True}),
                     ("fault_half_batch", {"rows_used": B // 2})):
        got = reference_run(cfg, traffic, seed, checked, dev, **kw)
        for k, v in compare(got, want, traffic["zero_grad_rule"]).items():
            out[f"{k}.{name}"] = v
        out[f"worst.{name}"] = (
            worst_leaves(got["grad_norms"], want["grad_norms"]) + " | "
            + worst_leaves(got["changes"], want["changes"]))
    out["losses.reference"] = want["losses"]
    return out


def run(job: bench.Job) -> dict:
    import torch

    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.core.broker import Broker
    from repro_torch.core.dstream import StreamingContext
    from repro_torch.core.rdd import Context
    from repro_torch.launch.train import assemble_batch
    from repro_torch.optim import init_opt_state
    from repro_torch.training import build_train_step

    cfg, traffic, settings = job.config, job.traffic, job.settings
    dev = torch.device(job.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    m, B, S = cfg["model"], traffic["batch"], traffic["seq"]
    config = program_config(cfg)
    opt_cfg = OptimizerConfig(**optimizer(traffic), zero1=False)
    b1 = opt_cfg.b1

    params = to_tree(weights.draw(m, job.seed, dev), m["num_layers"])
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    del params
    step_fn = build_train_step(config, opt_cfg)
    if job.fault == "state_unchanged":           # the harness's own tests
        def step_fn(state, batch, _fn=step_fn):
            import copy
            _, metrics = _fn(copy.deepcopy(state), batch)
            return state, metrics
    elif job.fault == "half_batch":
        def step_fn(state, batch, _fn=step_fn):
            return _fn(state, {k: v[:B // 2] for k, v in batch.items()})

    broker = Broker()
    broker.create_topic(TOPIC, partitions=1)
    sc = StreamingContext(Context(), broker, max_records_per_partition=B)
    sc.subscribe([TOPIC])
    holder = {"state": state}
    del state
    losses: list[float] = []

    def on_batch(rdd, info):
        # launch/train.py:run_train's on_batch, without its checkpoints
        records = rdd.collect()[:B]
        if len(records) < B:
            return None
        batch = assemble_batch(records, config, dev)
        holder["state"], metrics = step_fn(holder["state"], batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        return loss

    sc.foreach_batch(on_batch)
    rows_seen: list[np.ndarray] = []
    stream = rows(job.seed, S, m["vocab_size"])

    def unit() -> int:
        while sc.lag(TOPIC) < traffic["queued_batches"] * B:
            row = next(stream)
            if len(rows_seen) < traffic["checked_steps"] * B:
                rows_seen.append(row)
            broker.produce(TOPIC, {"tokens": row})
        info = sc.run_one_batch()
        return info.num_records * S

    def leaf_norms(tree: dict, scale: float = 1.0) -> dict:
        return {n: float(torch.linalg.vector_norm(t.float())) * scale
                for n, t in named(tree, m["num_layers"]).items()}

    prog: dict = {}
    unit()
    prog["grad_norms"] = leaf_norms(holder["state"]["opt"]["m"],
                                    1.0 / (1.0 - b1))
    for _ in range(traffic["checked_steps"] - 1):
        unit()
    w0 = weights.draw(m, job.seed, dev)
    master = named(holder["state"]["opt"].get("master",
                                             holder["state"]["params"]),
                   m["num_layers"])
    prog["changes"] = {n: float(torch.linalg.vector_norm(
        master[n].float() - w0[n].float())) for n in w0}
    del w0, master
    prog["losses"] = list(losses[:traffic["checked_steps"]])

    rec: dict = {"setup_s": time.perf_counter() - job.t_start}
    window_s, tokens, steps = loop.window(unit, job.seconds)
    rec.update(window_s=window_s, train_tokens=int(tokens), steps=steps,
               window_units=steps, batch=B, seq=S, model=m)
    if job.trace and dev.type == "cuda":
        rec["trace"] = loop.traced(unit, settings["trace_steps"], {
            "attention": ("repro_torch.models.attention",
                          "blocked_attention"),
            "adamw": ("repro_torch.training", "adamw_update")})
    rec["device"] = bench.device_info(torch, job.device)
    sc.foreach_batch(None)
    del holder, step_fn, sc, broker
    loop.release(torch)

    refr = reference_run(cfg, traffic, job.seed, np.stack(rows_seen), dev)
    gaps = compare(prog, refr, traffic["zero_grad_rule"])
    limits = settings["limits"]
    rec["checks"] = [{"name": k, "value": v, "limit": limits[k]}
                     for k, v in gaps.items() if k in limits]
    bench.log(f"train: losses {prog['losses']} against the reference's "
            f"{refr['losses']}; numbers {gaps}")
    bench.log(f"train: worst gradient leaves "
            f"{worst_leaves(prog['grad_norms'], refr['grad_norms'])}; worst "
            f"change leaves {worst_leaves(prog['changes'], refr['changes'])}")
    rec["correct"] = all(c["value"] <= c["limit"] for c in rec["checks"])
    rec["attempted"], rec["failed"] = steps, 0
    return rec
