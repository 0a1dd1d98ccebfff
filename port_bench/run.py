"""Run one benchmark cell once, from the root of a checkout:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The set-up time counts from here, before any import of the program.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    ROOT = Path.cwd()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from port_bench import bench

    bench.setup_environment(ROOT)
    sys.exit(bench.main(sys.argv[1:], T_START))
