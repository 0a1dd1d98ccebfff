#!/usr/bin/env python3
"""Design variants of the fp32 flash-attention kernel, timed on one GPU.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/flash_tf32x3_variants.py [name ...]

It builds tools/flash_tf32x3_variants.cu once for each entry of VARIANTS
(its -D switches), each by an nvcc of its own, all at once, into
build/flash_tf32x3_variants/. Each build, and the port's own kernel
(src/repro_torch/csrc/flash_attention_tf32x3.cu, built as the port builds
it), is held against the plain PyTorch version at six fp32 shapes: the
builds that are not ablations must agree within FLASH_TOL, and the ablations
report their error only. Then all are timed at the model's prefill (B 4,
S 1,024, H 16, hd 128) by CUDA events with the L2 emptied before each call,
in two rounds in opposite orders, each round beside
``scaled_dot_product_attention``. Last, mma.sync m16n8k8 TF32 alone: 8
independent chains a warp, 4 CTAs of 4 warps an SM. Names on the command
line pick some of the variants. Exits non-zero without a GPU or when a
build fails or disagrees.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "tools" / "flash_tf32x3_variants.cu"
OUT = ROOT / "build" / "flash_tf32x3_variants"

# name -> (-D switches, ablation: wrong results by construction)
VARIANTS = {
    "cvt": ("-DTF32X3_CVT", False),
    "int": ("", False),
    "int+step": ("-DTF32X3_LOAD_STEP", False),
    "8 warps, 2 stages, step": ("-DTF32X3_WARPS=8 -DTF32X3_STAGES=2 "
                                "-DTF32X3_LOAD_STEP", False),
    "step, small truncated": ("-DTF32X3_LOAD_STEP -DTF32X3_SMALL_TRUNC",
                              False),
    "step, L2 prefetch 2 tiles": ("-DTF32X3_LOAD_STEP -DPREFETCH_L2=2",
                                  False),
    "ablation: no split": ("-DTF32X3_LOAD_STEP -DAB_NOSPLIT", True),
    "ablation: big.big only, no split": ("-DTF32X3_LOAD_STEP -DAB_ONE "
                                         "-DAB_NOSPLIT", True),
    "ablation: no expf": ("-DTF32X3_LOAD_STEP -DAB_NOEXP", True),
    "ablation: K, V copied once": ("-DTF32X3_LOAD_STEP -DAB_NOLOAD", True),
}
SHAPES = ((4, 64, 1, 16), (4, 128, 1, 32), (4, 32, 1, 8), (2, 130, 4, 128),
          (1, 1000, 16, 128), (4, 1024, 16, 128))


def _ptxas_hd128(err: str) -> str:
    """ptxas's registers and spills of the hd-128 instance."""
    lines = err.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "ILi128E" in line:
            return "; ".join(rest.split(":")[-1].strip()
                             for rest in lines[i + 1:i + 5]
                             if "Used" in rest or "spill" in rest)
    return "not found"


def build(names: list[str]) -> dict[str, Path]:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {}
    for i, name in enumerate(names):
        lib = OUT / f"variant{i}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", *VARIANTS[name][0].split(),
               "-o", str(lib), str(SOURCE)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                             stderr=subprocess.PIPE,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        print(f"  built {name}: hd-128 instance {_ptxas_hd128(err)}")
        libs[name] = lib
    return libs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("flash_tf32x3_variants: no GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fo

    names = sys.argv[1:] or list(VARIANTS)
    print(cs._nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    _build.load_library()
    libs = build(names)
    print(f"  builds done in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(cs.SEED)
    inputs = {sh: [torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)).to(dev) for _ in range(3)] for sh in SHAPES}
    plain = {sh: fo.flash_attention(*x, use_kernel=False)
             for sh, x in inputs.items()}
    stream = torch.cuda.current_stream(dev).cuda_stream

    calls = {"port": lambda q, k, v: fk.flash_attention(q, k, v)}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.variant_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int64] * 4 + [ctypes.c_void_p]
        lib.variant_launch.restype = ctypes.c_int

        def call(q, k, v, lib=lib, name=name):
            o = torch.empty_like(q)
            rc = lib.variant_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    o.data_ptr(), *q.shape, stream)
            if rc != 0:
                raise RuntimeError(f"{name}: launch failed with {rc}")
            return o
        calls[name] = call
    tol = cs.FLASH_TOL["float32"]
    for name, call in calls.items():
        errs = []
        for sh, x in inputs.items():
            got = call(*x)
            torch.cuda.synchronize()
            errs.append(float((got - plain[sh]).abs().max()))
            if not VARIANTS.get(name, ("", False))[1]:
                torch.testing.assert_close(got, plain[sh], rtol=tol, atol=tol)
        print(f"  {name}: max|kernel - plain| at {len(SHAPES)} shapes "
              f"{[f'{e:.3g}' for e in errs]}", flush=True)

    q, k, v = inputs[SHAPES[-1]]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    times = {name: [] for name in [*calls, "SDPA"]}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            times[name].append(cs._time_ms(
                torch, lambda c=calls[name]: c(q, k, v), flush=flush.zero_))
        times["SDPA"].append(cs._time_ms(
            torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), flush=flush.zero_))
    for name, ts in times.items():
        print(f"  {name}: model shape {' / '.join(f'{t:.4f}' for t in ts)} "
              f"ms (two rounds)", flush=True)

    if libs:
        lib = ctypes.CDLL(str(next(iter(libs.values()))))
        lib.mma_peak_launch.argtypes = [ctypes.c_void_p] + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        blocks, threads, iters = 4 * n_sm, 128, 4096
        out = torch.empty(blocks * threads, device=dev)
        ms = cs._time_ms(torch, lambda: lib.mma_peak_launch(
            out.data_ptr(), blocks, threads, iters, stream), reps=5)
        flops = blocks * threads // 32 * 8 * iters * 2 * 16 * 8 * 8
        print(f"  mma.sync m16n8k8 TF32 alone: {flops / ms / 1e9:.1f} "
              f"TFLOP/s ({ms:.3f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
