"""The harness: one run of one cell, found by name.

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs from the root of a checkout. Everything that belongs
to one configuration, traffic mix, cell or metric is a file of its own,
found by the names in ``BENCHMARK.json``:

* ``port_bench/configs/<config>.json``: the configuration as it is run;
* ``port_bench/traffic/<traffic>.json``: the traffic mix, whose
  ``driver`` names the generator and loop in ``port_bench/drivers/``;
* ``port_bench/workloads/<cell>.json``: the cell's own settings (the
  limits of its correctness check, the units its trace covers);
* ``port_bench/metrics/<metric>.py``: the metric's reader, ``read(rec)``,
  which returns the number from a run's record or None when the record
  holds nothing to read. A metric split by cell (``idle_share.tomo``,
  ``idle_share.train``) without a file of its own reads with the reader
  of the part of its name before the first dot (``idle_share.py``).

A run prints the compared numbers with their limits as its last lines on
standard error and, as its last line on standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, ``breakdown`` with ``--trace 1``, and last ``checks``.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any

BENCH_DIR = "port_bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    """A run that cannot produce a result (exit code 2)."""


@dataclass
class Job:
    """What a driver gets: the cell's files, read, and the run's
    arguments. ``fault`` and ``overrides`` are for the harness's own tests:
    a fault breaks the timed path underneath, an override shrinks the
    configuration to a size a CPU holds."""
    root: Path
    cell: dict
    config: dict
    traffic: dict
    settings: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    fault: str | None = None


def log(msg: str) -> None:
    """A line of the run's account on standard error."""
    print(msg, file=sys.stderr, flush=True)


# -- the spec and its files ----------------------------------------------------
def load_spec(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise BenchError(f"no BENCHMARK.json in {root}")
    return json.loads(path.read_text())


def _named(entries: list[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise BenchError(f"BENCHMARK.json names no {what} {name!r}")


def _json(root: Path, *parts: str) -> dict:
    path = root.joinpath(BENCH_DIR, *parts)
    if not path.is_file():
        raise BenchError(f"missing {path.relative_to(root)}")
    return json.loads(path.read_text())


def load_module(path: Path, name: str) -> Any:
    """A module from its file, whatever characters its name holds."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise BenchError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_files(root: Path, workload: str) -> tuple[dict, dict, dict, dict]:
    """(cell, configuration, traffic, settings) of ``workload``."""
    spec = load_spec(root)
    cell = _named(spec["workloads"], workload, "workload")
    entry = _named(spec["configs"], cell["config"], "configuration")
    config = json.loads((root / entry["file"]).read_text())
    traffic = _json(root, "traffic", f"{cell['traffic']}.json")
    settings = _json(root, "workloads", f"{workload}.json")
    return cell, config, traffic, settings


def cell_metrics(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones with
    ``trace`` off, the per-layer ones with it on; a metric with a
    ``workloads`` key only in the cells it lists."""
    pool = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in pool if workload in m.get("workloads", [workload])]


def reader_path(root: Path, name: str) -> Path:
    """The file of metric ``name``'s reader: ``metrics/<name>.py``, else
    that of the part of the name before its first dot."""
    metrics = root / BENCH_DIR / "metrics"
    for stem in (name, name.split(".")[0]):
        if (metrics / f"{stem}.py").is_file():
            return metrics / f"{stem}.py"
    raise BenchError(f"no reader for {name} in {metrics.relative_to(root)}")


def read_metrics(root: Path, metrics: list[dict], rec: dict) -> dict:
    """Each metric's reader over the run's record; a metric whose reader
    finds nothing to read is left out."""
    out = {}
    for m in metrics:
        path = reader_path(root, m["name"])
        value = load_module(path, f"port_bench_metric_{len(out)}").read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def load_driver(root: Path, name: str) -> Any:
    path = root / BENCH_DIR / "drivers" / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no driver {path.relative_to(root)}")
    return load_module(path, f"port_bench_driver_{name}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the runs may not load:
    the JAX stack and the JAX package, compared whole (``repro_torch`` is
    not ``repro``)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


# -- one run -------------------------------------------------------------------
def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             fault: str | None = None,
             overrides: dict | None = None) -> dict:
    """Run ``workload`` once and return its result object."""
    spec = load_spec(root)
    cell, config, traffic, settings = cell_files(root, workload)
    if overrides:
        config = {**config, **overrides.get("config", {})}
        traffic = {**traffic, **overrides.get("traffic", {})}
        settings = {**settings, **overrides.get("settings", {})}
    job = Job(root=root, cell=cell, config=config, traffic=traffic,
              settings=settings, seed=seed, seconds=seconds, trace=trace,
              device=device, t_start=t_start, fault=fault)
    rec = load_driver(root, traffic["driver"]).run(job)
    metrics = read_metrics(root, cell_metrics(spec, workload, trace), rec)
    result: dict[str, Any] = {
        "correct": bool(rec["correct"]),
        "attempted": int(rec["attempted"]),
        "failed": int(rec["failed"]),
        "metrics": metrics,
        "device": dict(rec["device"]),
    }
    if trace:
        tr = rec.get("trace") or {}
        if tr:
            result["device"]["busy_s"] = tr["busy_s"]
            result["device"]["window_s"] = tr["window_s"]
            result["breakdown"] = {"device_ops": tr["device_ops"],
                                   "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in rec["checks"]}
    return result


def device_info(torch: Any, device: str) -> dict:
    """The result's ``device``: one card, its peak allocated bytes."""
    if device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def main(argv: list[str] | None, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    try:
        spec = load_spec(root)
        cell = _named(spec["workloads"], args.workload, "workload")
    except BenchError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    if not (root / "src" / "repro_torch").is_dir():
        print(f"port_bench: no program (src/repro_torch) in {root}",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"port_bench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        result = run_cell(root, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", t_start)
    except BenchError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"port_bench: the run loaded {found}, which the benchmark "
              f"may not load", file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def setup_environment(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout, and no
    library loading JAX behind the program's back."""
    build = root / "build" / "port_bench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
