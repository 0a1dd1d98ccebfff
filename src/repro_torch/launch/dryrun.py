"""Multi-node dry-run: trace EVERY (arch × shape × mesh) cell of the port on
fake tensors, the counterpart of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell on 512 placeholder devices
and reads XLA's memory analysis and a walk of the HLO. The port runs one
rank's step (``training.lower_cell``, or ``parallel/dp.lower_dp_cell``
with ``{"_trainer": "dp"}``) on the production mesh under torch's fake
process group at its world (256, or 512 for two pods) and
``FakeTensorMode``, so nothing is allocated and no collective runs; the
walker of ``launch/opcost.py`` counts the rank's products, bytes and
collective wire bytes as the step dispatches them and follows its live
storages to their peak. From these it derives the roofline terms on the
card's constants (``launch/mesh.py``) and appends a JSON record under
``results/dryrun_torch/<single|multi>/<arch>__<shape><tag>.json``
(resumable; failures recorded with their tracebacks):

  arch, shape, mesh, chips, tag, ok; trace_s (the reference's lower_s and
  compile_s); memory: argument_bytes (this rank's shards of the state and
  the batch), output_bytes, alias_bytes (outputs written into arguments),
  temp_bytes, peak_bytes and peak_scope (where the peak was reached);
  cost (the reference's hlo_cost: flops, bytes, nvlink_bytes,
  network_bytes, transcendentals, collectives by kind, the kernel
  operators' calls); breakdown (the cost by scope: layer,
  attention, MLP or experts, CE chunk, optimizer, their backward and
  recompute); roofline: compute_s, memory_s, nvlink_s, network_s,
  dominant, model_flops, model_flops_per_chip, useful_ratio,
  params_total, params_active.

The mesh is built on ``--device``'s type (``cuda`` by default, fake CUDA
tensors, so that the flash kernel's operator is what a prefill traces);
``--device cpu`` traces on the host, as the CPU tests do. On a torch
without CUDA a ``cuda`` cell fails at the mesh and is recorded so; nothing
falls back to the CPU. A real process group in the process is refused:
the fake group takes the default group's place for the cell.

Usage:
    python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both --skip-existing
    python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
        --shape prefill_32k --device cpu --save-trace
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import math
import os
import time
import traceback
from typing import Any, Iterator

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, all_archs, applicable_shapes, \
    get_config
from repro_torch.configs.base import ModelConfig, OptimizerConfig, \
    ShapeConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.opcost import OpCost
from repro_torch.models.registry import param_shapes
from repro_torch.utils import human_bytes, peak_memory_bytes, tree_leaves

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "dryrun_torch")
REAL_GROUP = ("the dry-run runs each cell under a fake process group of "
              "the mesh's world; this process already has a process group")


def model_param_counts(config: ModelConfig) -> tuple[int, int]:
    """(total, active-per-token) parameter counts, from the family's
    parameters on the meta device; padded experts (the all-to-all path)
    count in the total and not in the active compute, as in the
    reference."""
    total = sum(leaf.numel() for leaf in tree_leaves(param_shapes(config)))
    active = total
    if config.num_experts > 0:
        from repro_torch.models.moe import padded_experts
        per_expert = config.d_model * config.d_ff * (3 if config.mlp_gated
                                                     else 2)
        expert_total_padded = (config.num_layers * padded_experts(config)
                               * per_expert)
        expert_active = (config.num_layers * config.experts_per_token
                         * per_expert)
        active = total - expert_total_padded + expert_active
    return total, active


def _attn_layers(config: ModelConfig) -> int:
    from repro_torch.models.rglru import layer_kinds
    return sum(k == "attn" for k in layer_kinds(config))


def model_flops(config: ModelConfig, shape: ShapeConfig) -> float:
    """Analytical 'useful' FLOPs per step (the 6·N·D yardstick + attention),
    the reference's formulas."""
    _, n_active = model_param_counts(config)
    B, S = shape.global_batch, shape.seq_len
    hd = config.resolved_head_dim
    h = config.num_heads
    if shape.kind == "train":
        tokens = B * S
        base = 6.0 * n_active * tokens
        if config.family in ("dense", "moe", "vlm", "audio"):
            n_attn = config.num_layers + config.encoder_layers
            base += 6.0 * B * S * S * h * hd * n_attn / 2  # causal half
        elif config.family == "hybrid":
            w = min(config.local_window, S)
            base += 6.0 * B * S * w * h * hd * _attn_layers(config)
        return base
    if shape.kind == "prefill":
        tokens = B * S
        base = 2.0 * n_active * tokens
        if config.family in ("dense", "moe", "vlm", "audio"):
            n_attn = config.num_layers + config.encoder_layers
            base += 2.0 * B * S * S * h * hd * n_attn / 2
        elif config.family == "hybrid":
            base += (2.0 * B * S * min(config.local_window, S) * h * hd
                     * _attn_layers(config))
        return base
    # decode: one token, full cache read
    base = 2.0 * n_active * B
    if config.family in ("dense", "moe", "vlm", "audio"):
        base += 4.0 * B * S * h * hd * config.num_layers
    elif config.family == "hybrid":
        base += (4.0 * B * min(config.local_window, S) * h * hd
                 * _attn_layers(config))
    elif config.family == "ssm":
        base += 4.0 * B * config.num_layers * config.num_heads * hd * hd
    return base


@contextlib.contextmanager
def fake_group(world: int) -> Iterator[None]:
    """torch's fake process group as the default group at ``world``, this
    process rank 0, for one cell; refused where a group exists already."""
    if dist.is_initialized():
        raise RuntimeError(REAL_GROUP)
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _storages(tree: Any) -> dict[int, int]:
    from repro_torch.parallel.sharding import is_dtensor
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if is_dtensor(t) else t
            st = t.untyped_storage()
            out[id(st)] = st.nbytes()
    return out


def trace_cell(cell: Any, *, fake: bool = True, rows: bool = False
               ) -> dict:
    """Run ``cell`` once under the walker (on fake tensors unless ``fake``
    is False) with its inputs drawn first and counted live from the start.
    Returns {'cost', 'breakdown', 'memory', 'trace_s', 'rows'}."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.perf_counter()
    with FakeTensorMode() if fake else contextlib.nullcontext():
        args = cell.inputs()
        walker = OpCost(memory=True, rows=rows)
        arg_bytes = walker.track(args)
        arg_st = _storages(args)
        with walker:
            out = cell(*args)
        out_st = _storages(out)
    trace_s = time.perf_counter() - t0
    output = sum(out_st.values())
    alias = sum(b for k, b in out_st.items() if k in arg_st)
    peak = walker.peak_bytes
    memory = {"argument_bytes": arg_bytes, "output_bytes": output,
              "alias_bytes": alias,
              "temp_bytes": max(0, peak - arg_bytes - (output - alias)),
              "peak_bytes": peak, "peak_scope": walker.peak_scope}
    return {"cost": walker.result(), "breakdown": walker.breakdown(),
            "memory": memory, "trace_s": trace_s, "rows": walker.rows}


def roofline(cost: dict, config: ModelConfig, shape: ShapeConfig,
             n_chips: int) -> dict:
    """The roofline terms of a rank's cost on the card's constants, beside
    the model's useful FLOPs."""
    mf = model_flops(config, shape)
    n_total, n_active = model_param_counts(config)
    compute_s = cost["flops"] / mesh_lib.PEAK_FLOPS_BF16
    memory_s = cost["bytes"] / mesh_lib.HBM_BW
    nvlink_s = cost["nvlink_bytes"] / mesh_lib.NVLINK_BW
    network_s = cost["network_bytes"] / mesh_lib.NETWORK_BW
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", nvlink_s + network_s)),
                   key=lambda kv: kv[1])
    return {"compute_s": compute_s, "memory_s": memory_s,
            "nvlink_s": nvlink_s, "network_s": network_s,
            "dominant": dominant[0], "model_flops": mf,
            "model_flops_per_chip": mf / n_chips,
            "useful_ratio": (mf / n_chips) / max(cost["flops"], 1.0),
            "params_total": n_total, "params_active": n_active}


def run_cell(arch: str, shape: str | ShapeConfig, multi_pod: bool,
             outdir: str, *, device: str = "cuda",
             overrides: dict | None = None, tag: str = "",
             save_trace: bool = False, config: ModelConfig | None = None,
             mesh_shape: tuple | None = None) -> dict:
    """Trace one cell and write its record (the module docstring).
    ``shape`` is a name of ``SHAPES`` or a ``ShapeConfig``; ``config``
    replaces ``get_config(arch)`` (a reduced config) and ``mesh_shape``,
    (dims, axis names), the production mesh (a small one)."""
    config = config or get_config(arch)
    trainer = compression = opt = None
    if overrides:
        overrides = dict(overrides)
        trainer = overrides.pop("_trainer", None)
        compression = overrides.pop("_compression", None)
        opt_kw = overrides.pop("_opt", None)
        if opt_kw:
            opt = OptimizerConfig(**opt_kw)
        if overrides:
            config = config.replace(**overrides)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    dims, axes = mesh_shape or (
        ((2, 16, 16), ("pod", "data", "model")) if multi_pod
        else ((16, 16), ("data", "model")))
    n_chips = math.prod(dims)
    rec: dict = {"arch": arch, "shape": shape.name,
                 "mesh": "x".join(str(d) for d in dims), "chips": n_chips,
                 "tag": tag, "ok": False}
    with fake_group(n_chips):
        try:
            dev_type = torch.device(device).type
            if mesh_shape is None:
                mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                                     device_type=dev_type)
            else:
                from torch.distributed.device_mesh import init_device_mesh
                mesh = init_device_mesh(dev_type, dims, mesh_dim_names=axes)
            if trainer == "dp":
                from repro_torch.parallel.dp import lower_dp_cell
                cell = lower_dp_cell(config, shape, mesh, opt=opt,
                                     compression=compression)
            else:
                from repro_torch.training import lower_cell
                cell, _ = lower_cell(config, shape, mesh, opt=opt)
            traced = trace_cell(cell, rows=save_trace)
            rec["trace_s"] = round(traced["trace_s"], 1)
            rec["memory"] = traced["memory"]
            rec["cost"] = cost = traced["cost"]
            rec["breakdown"] = traced["breakdown"]
            rec["roofline"] = rf = roofline(cost, config, shape, n_chips)
            ma = rec["memory"]
            print(f"--- {arch} × {shape.name} × {rec['mesh']} memory "
                  f"(per rank): args={human_bytes(ma['argument_bytes'])} "
                  f"out={human_bytes(ma['output_bytes'])} "
                  f"temp={human_bytes(ma['temp_bytes'])} "
                  f"peak={human_bytes(peak_memory_bytes(ma))}; traced in "
                  f"{traced['trace_s']:.1f} s", flush=True)
            print(f"    cost: flops={cost['flops']:.3e} "
                  f"bytes={cost['bytes']:.3e} "
                  f"nvlink={cost['nvlink_bytes']:.3e} "
                  f"network={cost['network_bytes']:.3e}", flush=True)
            print(f"    roofline: compute={rf['compute_s'] * 1e3:.2f}ms "
                  f"memory={rf['memory_s'] * 1e3:.2f}ms "
                  f"nvlink={rf['nvlink_s'] * 1e3:.2f}ms "
                  f"network={rf['network_s'] * 1e3:.2f}ms "
                  f"dominant={rf['dominant']} "
                  f"useful={rf['useful_ratio']:.2f}", flush=True)
            rec["ok"] = True
            if save_trace:
                os.makedirs(outdir, exist_ok=True)
                with gzip.open(os.path.join(
                        outdir, f"{arch}__{shape.name}{tag}.trace.jsonl.gz"),
                        "wt") as f:
                    for row in traced["rows"]:
                        f.write(json.dumps(row) + "\n")
        except Exception:
            rec["error"] = traceback.format_exc()
            print(f"!!! {arch} × {shape.name} FAILED:\n{rec['error']}",
                  flush=True)
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, f"{arch}__{shape.name}{tag}.json"),
              "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def all_cells() -> list[tuple[str, str]]:
    """Every (arch, shape) the archs run, cheap cells first."""
    cells = [(arch, sh) for arch in all_archs()
             for sh in applicable_shapes(get_config(arch))]

    def cost_key(cell: tuple[str, str]) -> int:
        cfg = get_config(cell[0])
        return (cfg.num_layers * cfg.d_model * cfg.d_model
                * (3 if cell[1] == "train_4k" else 1))
    return sorted(cells, key=cost_key)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--save-trace", action="store_true",
                    help="also write the walker's rows, one an operation, "
                         "gzipped")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the mesh's and the fake tensors' device: cuda "
                         "(default) or cpu")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig overrides, and "
                         "_trainer ('dp'), _compression, _opt")
    ap.add_argument("--tag", default="",
                    help="suffix for the result JSON")
    args = ap.parse_args(argv)
    overrides = json.loads(args.override) if args.override else None

    if args.all:
        cells = all_cells()
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    base_out = args.out or os.path.normpath(RESULTS)
    n_ok = n_fail = n_skip = 0
    for multi in meshes:
        outdir = os.path.join(base_out, "multi" if multi else "single")
        for arch, sh in cells:
            path = os.path.join(outdir, f"{arch}__{sh}{args.tag}.json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("ok"):
                        n_skip += 1
                        continue
            rec = run_cell(arch, sh, multi, outdir, device=args.device,
                           overrides=overrides, tag=args.tag,
                           save_trace=args.save_trace)
            n_ok += rec["ok"]
            n_fail += not rec["ok"]
    print(f"dry-run done: ok={n_ok} fail={n_fail} skipped={n_skip}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
