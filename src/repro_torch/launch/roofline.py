"""Roofline table of the port's dry-run records
(``results/dryrun_torch``, ``launch/dryrun.py``): the counterpart of
``repro/launch/roofline.py``, with the card's collective terms, NVLink
inside a node and the network across nodes, where the reference has ICI
and DCN.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh single] [--md]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

RESULTS = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch"))

BOTTLENECK_FIXES = {
    "compute": "more cards / less remat recompute / the triangular "
               "schedule's causal saving / the flash kernel where the "
               "reference takes it",
    "memory": "fewer passes over the same tensors: fused elementwise "
              "kernels (each eager operation reads and writes HBM), the "
              "flash kernel in place of materialised scores, bf16 "
              "intermediates",
    "collective": "re-layout parallelism (keep tensor parallelism inside "
                  "a node's NVLink, less of it for small models, EP "
                  "dispatch locality for MoE) / compressed or overlapped "
                  "collectives",
}


def load(mesh: str = "single", tag: str = "",
         results: str = RESULTS) -> list[dict]:
    """The ok records of ``mesh`` with exactly ``tag``."""
    rows = []
    for f in sorted(glob.glob(os.path.join(results, mesh, f"*{tag}.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if r.get("ok") and r.get("tag", "") == tag:
            rows.append(r)
    return rows


def table(rows: list[dict], md: bool = True) -> str:
    out = []
    hdr = ("arch", "shape", "compute_s", "memory_s", "nvlink_s", "net_s",
           "dominant", "MODEL_FLOPS", "useful", "peak_GiB")
    if md:
        out.append("| " + " | ".join(hdr) + " |")
        out.append("|" + "---|" * len(hdr))
    else:
        out.append(",".join(hdr))
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        rf = r["roofline"]
        cells = (r["arch"], r["shape"], f"{rf['compute_s']:.3f}",
                 f"{rf['memory_s']:.3f}", f"{rf['nvlink_s']:.3f}",
                 f"{rf['network_s']:.3f}", rf["dominant"],
                 f"{rf['model_flops']:.2e}", f"{rf['useful_ratio']:.2f}",
                 f"{r['memory']['peak_bytes'] / 2**30:.1f}")
        out.append(("| " + " | ".join(cells) + " |") if md
                   else ",".join(cells))
    return "\n".join(out)


def dominant_lines(rows: list[dict]) -> list[str]:
    """The cells grouped by their dominant term, each group with its
    fixes."""
    doms: dict[str, list[str]] = {}
    for r in rows:
        doms.setdefault(r["roofline"]["dominant"], []).append(
            f"{r['arch']}×{r['shape']}")
    lines = []
    for dom, cells in sorted(doms.items()):
        lines.append(f"**{dom}-bound** ({len(cells)}): {', '.join(cells)}")
        lines.append(f"  -> {BOTTLENECK_FIXES[dom]}")
    return lines


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--tag", default="")
    ap.add_argument("--results", default=RESULTS)
    ap.add_argument("--md", action="store_true", default=True)
    args = ap.parse_args(argv)
    rows = load(args.mesh, args.tag, args.results)
    print(table(rows, md=args.md))
    print()
    for line in dominant_lines(rows):
        print(line)


if __name__ == "__main__":
    main()
