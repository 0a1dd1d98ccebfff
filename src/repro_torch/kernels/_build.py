"""Build, load and call the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled for Hopper (``sm_90a``) by an
``nvcc`` of its own, all started together, and the objects are linked into
``build/repro_torch/librepro_torch_kernels.so`` at the root of the
checkout, at first use; the library is loaded with ``ctypes``. The sources
have a plain C interface and include no PyTorch header, so the build takes
seconds; pointers and the stream cross as ``c_void_p``, counts and sizes
as ``c_int64`` and beta as ``c_float``. The library is rebuilt when the
hash of the sources and flags changes. nvcc's stderr, with ptxas's
registers, shared memory and spills of every kernel (``-Xptxas -v``), is
kept beside the library as ``nvcc.log``, the sources' in their order. A
failed build raises with nvcc's stderr: there is no fallback to the plain
PyTorch versions. The first use is safe from several threads (the RDD
scheduler's executors launch kernels): one builds and loads the library,
the others wait for it. Each wrapper counts its launches under
:data:`COUNT_LOCK` for the same reason.

Nothing here runs at import time, so the CPU tests import every module
without nvcc or a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from repro_torch.utils import get_logger

log = get_logger(__name__)

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
LOG_NAME = "nvcc.log"
# no --use_fast_math: the kernels must round as the plain versions do
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
# C entry point -> argument types; every entry returns a cudaError_t as int
SIGNATURES = {
    "modulus_project_launch": (_P, _P, _P, ctypes.c_int64, _P),
    "overlap_products_launch": (_P, _P, _P, _P, ctypes.c_int64,
                                ctypes.c_int64, _P),
    "raar_combine_launch": (_P, _P, _P, _P, _P, ctypes.c_int64,
                            ctypes.c_float, _P),
    "art_sweep_csr_launch": (_P, _P, _P, _P, _P, _P, ctypes.c_int64,
                             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                             ctypes.c_float, _P),
    "flash_attention_launch": (_P, _P, _P, _P, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_int64, _P),
    "flash_attention_tf32x3_launch": (_P, _P, _P, _P, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, _P),
    "flash_attention_wgmma_launch": (_P, _P, _P, _P, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, _P),
}


def find_nvcc() -> str:
    """nvcc from PATH, else from ``$CUDA_HOME`` (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found is not None:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME; the "
                       "CUDA toolkit is needed to build the port's kernels")


def source_digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _replace_durably(tmp: Path, path: Path) -> None:
    with open(tmp, "rb+") as f:
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _compile_all(nvcc: str, sources: list[Path], obj_dir: Path) -> list[Path]:
    """One ``nvcc -c`` a source, all running at once; returns the objects
    and writes each one's stderr beside it. Raises with the stderr of every
    compile that failed."""
    objs = [obj_dir / f"{src.stem}.o" for src in sources]
    procs = []
    for src, obj in zip(sources, objs):
        with open(obj.with_suffix(".log"), "w") as err:
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.DEVNULL, stderr=err, text=True))
    done = [(src, obj, proc.wait()) for src, obj, proc
            in zip(sources, objs, procs)]
    failed = [(src, obj, rc) for src, obj, rc in done
              if rc != 0 or not obj.exists()]
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(
            f"{src.name} (exit code {rc}):\n"
            f"{obj.with_suffix('.log').read_text()}"
            for src, obj, rc in failed))
    return objs


def build(src_dir: Path = SRC_DIR, build_dir: Path = BUILD_DIR,
          nvcc: str | None = None) -> Path:
    """Compile ``src_dir/*.cu`` into ``build_dir/LIB_NAME`` unless a library
    built from the same sources and flags is already there; returns its
    path. Raises ``RuntimeError`` with nvcc's stderr when nvcc fails."""
    sources = sorted(Path(src_dir).glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources in {src_dir}")
    digest = source_digest(sources)
    build_dir = Path(build_dir)
    lib = build_dir / LIB_NAME
    stamp = build_dir / (LIB_NAME + ".sha256")
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    # temp names per process and thread: two builders at once each finish
    # with a whole library, and the last os.replace wins
    tag = f"{os.getpid()}.{threading.get_ident()}"
    tmp = build_dir / f"{LIB_NAME}.{tag}.tmp"
    nvcc = nvcc or find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build_dir) as obj_dir:
        objs = _compile_all(nvcc, sources, Path(obj_dir))
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0 or not tmp.exists():
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to link with exit code "
                               f"{proc.returncode}: {' '.join(cmd)}\n"
                               f"{proc.stderr}")
        log_text = "".join(o.with_suffix(".log").read_text() for o in objs)
    _replace_durably(tmp, lib)
    (build_dir / LOG_NAME).write_text(log_text + proc.stderr)
    stamp_tmp = build_dir / f"{stamp.name}.{tag}.tmp"
    stamp_tmp.write_text(digest)
    _replace_durably(stamp_tmp, stamp)
    log.info("built %s from %d sources in %.2f s", lib, len(sources),
             time.perf_counter() - t0)
    return lib


_library: ctypes.CDLL | None = None
_library_lock = threading.Lock()
# held while a wrapper adds to its launch counters
COUNT_LOCK = threading.Lock()


def load_library() -> ctypes.CDLL:
    """The built kernel library, built and loaded by the first call in a
    process; a call made while another thread builds waits for it."""
    global _library
    if _library is None:
        with _library_lock:
            if _library is None:
                lib = ctypes.CDLL(str(build()))
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                _library = lib
    return _library


def check_tensor(op: str, name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple[int, ...], device: torch.device | None = None
                 ) -> None:
    """Raise unless ``t`` is what a kernel reads through ``data_ptr()``: a
    contiguous CUDA tensor of ``dtype`` and ``shape`` (on ``device`` when
    given) with no lazy conjugate or negative bit."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{op}: {name} must be a tensor, got {type(t)}")
    if t.device.type != "cuda":
        raise ValueError(f"{op}: {name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{op}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{op}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")
    if t.is_conj() or t.is_neg():
        raise ValueError(f"{op}: {name} carries a lazy conj/neg bit; "
                         "call .resolve_conj().resolve_neg() first")


def check_launch(op: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{op}: kernel launch failed with cudaError_t {rc}")


def current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
