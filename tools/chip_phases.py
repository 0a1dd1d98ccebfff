#!/usr/bin/env python3
"""Some phases of ``chip_smoke.py`` alone, on one NVIDIA GPU: the kernels
built first (phase 2's build, without its SDPA trace), then each phase
named on the command line, in the order given, each ending with its own
``[N] done in X s`` line.

Run from the root of a checkout:

    python3 tools/chip_phases.py 27 28 22 23 26

The phases whose functions take only the card (``torch``, the device and
the nvidia-smi line) are offered: 16-18 and 20-31 but 21, which needs
phase 8's stream; and phase 9, the flash kernels against their plain
version, with its own buffer to empty the L2. Without a GPU it exits
non-zero.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

PHASES = {"16": "bridge_phase", "17": "elastic_phase",
          "18": "recovery_phase", "20": "moe_phase", "22": "hybrid_phase",
          "23": "audio_phase", "24": "ssm_phase", "25": "vlm_phase",
          "26": "train_phase", "27": "schedules_phase", "28": "dp_phase",
          "29": "mesh_phase", "30": "a2a_pp_phase", "31": "dryrun_phase",
          "9": "flash_phase"}


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_phases: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    unknown = [p for p in argv if p not in PHASES]
    if not argv or unknown:
        print(f"chip_phases: name phases among {sorted(PHASES)}",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    _build.load_library()
    dev = torch.device("cuda", 0)
    smi = cs._nvidia_smi()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s; {smi}; "
          f"torch {torch.__version__} (CUDA {torch.version.cuda})",
          flush=True)
    for phase in argv:
        with cs._phase(phase, f"chip_smoke.{PHASES[phase]} alone:"):
            if phase == "9":
                l2_flush = torch.empty(64 * 2**20, dtype=torch.float32,
                                       device=dev)
                cs.flash_phase(torch, dev, l2_flush.zero_)
                del l2_flush
            else:
                getattr(cs, PHASES[phase])(torch, dev, smi)
    print(f"all in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
