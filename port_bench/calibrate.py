"""The readings a cell's correctness limits are set from, on the card.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3

For each seed it prints one JSON line with the control's readings: the
plain reference put in the program's place and computed one precision
step below the configuration's (and, for a training cell, the faults a
training step can have), compared by the cell's own comparison at the
cell's own size. The program's own readings come from the cell's runs,
which print every compared number beside its limit.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path


def main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    root = Path.cwd()
    from port_bench import bench

    bench.setup_environment(root)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell, config, traffic, settings = bench.cell_files(root, args.workload)
    driver = bench.load_driver(root, traffic["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        readings = driver.control_readings(config, traffic, seed, "cuda")
        readings.update(workload=args.workload, seed=seed,
                        seconds=time.perf_counter() - t0)
        print(json.dumps(readings), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(Path.cwd()), str(Path.cwd() / "src")]
    sys.exit(main(sys.argv[1:]))
