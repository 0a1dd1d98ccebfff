#!/usr/bin/env python3
"""The bf16 prefill of every arch served through the flash kernel, timed
on one GPU, for one or more checkouts in turn.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/prefill_ab.py [ROOT ...]

Each ROOT (default: this checkout) is the root of a checkout of the repo,
run in a process of its own in the order given, so that ``OLD NEW NEW OLD``
compares two trees on one card. A process builds that checkout's kernels,
then for each arch of ARCHS draws the weights at full width in bf16 from
seed 0 and times, by CUDA events, the model's ``prefill`` at the serve
phases' batch (the path ``run_serve`` takes for a batch of requests) and
the flash kernel alone at that prefill's shape: the median and the range
of REPS calls after WARMUP. It prints one JSON line a checkout, and a table
of all of them at the end. Exits non-zero without a GPU, when a checkout's
process fails, or when a prefill does not launch the kernel once a layer.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# arch -> (batch, prompt tokens, the encoder's frames or 0)
ARCHS = {
    "internlm2-1.8b": (4, 1024, 0),
    "minitron-8b": (4, 1024, 0),
    "starcoder2-3b": (4, 1024, 0),
    "gemma-7b": (4, 1024, 0),
    "granite-moe-3b-a800m": (4, 1024, 0),
    "whisper-medium": (4, 384, 1500),
}
WARMUP, REPS, SEED = 3, 15, 0


def _timed(torch, fn) -> list[float]:
    for _ in range(WARMUP):
        fn()
    out = []
    for _ in range(REPS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return sorted(out)


def child(root: Path) -> int:
    """Times every arch of ARCHS in the checkout at ``root``; prints the
    result as the last line."""
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, reset_launch_counts
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.models.registry import get_model

    _build.build()
    _build.load_library()
    dev = torch.device("cuda", 0)
    result = {"root": str(root), "archs": {}}
    for arch, (B, S, frames) in ARCHS.items():
        config = get_config(arch).replace(dtype="bfloat16",
                                          param_dtype="bfloat16")
        model = get_model(config)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                            config)
        rng = np.random.default_rng(SEED)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, config.vocab_size, (B, S))).to(dev)}
        if frames:
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (B, frames, config.d_model)).astype(np.float32)).to(dev)
        H, hd = config.num_heads, config.resolved_head_dim
        qkv = [torch.randn((B, S, H, hd), device=dev, dtype=torch.bfloat16,
                           generator=torch.Generator(device=dev)
                           .manual_seed(SEED + i)) for i in range(3)]
        with torch.inference_mode():
            reset_launch_counts()
            model.prefill(params, batch, config, max_len=S + 16)
            torch.cuda.synchronize()
            launches = flash.flash_attention.launches
            prefill = _timed(torch, lambda: model.prefill(
                params, batch, config, max_len=S + 16))
            kernel = _timed(torch, lambda: flash.flash_attention(*qkv))
        if launches != config.num_layers:
            print(f"prefill_ab: {arch} launched the kernel {launches} times "
                  f"in a prefill of {config.num_layers} layers",
                  file=sys.stderr)
            return 1
        result["archs"][arch] = {
            "shape": [B, S, H, hd], "launches": launches,
            "prefill_ms": [prefill[REPS // 2], prefill[0], prefill[-1]],
            "kernel_ms": [kernel[REPS // 2], kernel[0], kernel[-1]]}
        del params, batch, qkv
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        return child(Path(argv[1]).resolve())
    import torch
    if not torch.cuda.is_available():
        print("prefill_ab: one NVIDIA GPU is needed", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs = []
    for i, root in enumerate(argv or [str(ROOT)]):
        proc = subprocess.run([sys.executable, __file__, "--child", root],
                              capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode:
            print(f"prefill_ab: run {i} ({root}) exited {proc.returncode}",
                  file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps({"run": i, **runs[-1]}), flush=True)
    print(f"median [min, max] of {REPS} calls, ms, on {smi}:")
    for arch in ARCHS:
        for i, run in enumerate(runs):
            r = run["archs"][arch]
            p, k = r["prefill_ms"], r["kernel_ms"]
            print(f"  {arch:22s} run {i} {run['root']}: prefill {p[0]:.3f} "
                  f"[{p[1]:.3f}, {p[2]:.3f}], flash {k[0]:.4f} "
                  f"[{k[1]:.4f}, {k[2]:.4f}] x {r['launches']} (B, S, H, hd "
                  f"{tuple(r['shape'])})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
