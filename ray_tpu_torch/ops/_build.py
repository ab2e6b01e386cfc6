"""Builds the port's CUDA kernels and binds them with ctypes.

Every ``ops/csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one process per source, all
started together, and linked into one shared library under
``build/ray_tpu_torch/`` at the repository root. The library's name carries
a hash of the sources and flags, so a changed source is rebuilt and an
unchanged one is loaded as it is. The library has a plain C interface and is
loaded with ``ctypes``; it includes no PyTorch header, which keeps a build to
seconds.

Each C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise through :func:`check` if it is not 0. A failed build raises
with nvcc's output. Nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# dtype codes understood by the C entry points (csrc/common.cuh DType).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Seconds the last build in this process took (None: nothing was built).
build_seconds: Optional[float] = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin; the port's "
            "CUDA kernels are built from ops/csrc at first use"
        )
    return path


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libray_tpu_torch_{source_hash()}.so"


def build_log_path() -> Path:
    return BUILD_DIR / f"build_{source_hash()}.log"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    work = BUILD_DIR / f"tmp_{os.getpid()}_{threading.get_ident()}"
    work.mkdir(parents=True, exist_ok=True)
    try:
        procs = []
        for src in sources():
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(work / f"{src.stem}.o")]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], False
        for cmd, proc in procs:
            text, _ = proc.communicate()
            log.append(f"$ {' '.join(cmd)}\n{text}")
            failed |= proc.returncode != 0
        if not failed:
            tmp_so = work / out.name
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so),
                   *(str(work / f"{s.stem}.o") for s in sources())]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            log.append(f"$ {' '.join(cmd)}\n{proc.stdout}")
            failed = proc.returncode != 0
        build_log_path().write_text("\n".join(log))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(log))
        os.replace(tmp_so, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return out


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rtt_flash_fwd.argtypes = [
        i, p, p, p, p, p, i, i, i, i, i, i, p, f, i, i, i, p]
    lib.rtt_flash_fwd.restype = i
    lib.rtt_flash_bwd_dq.argtypes = [
        i, p, p, p, p, p, p, p, i, i, i, i, i, i, p, f, i, i, i, p]
    lib.rtt_flash_bwd_dq.restype = i
    lib.rtt_flash_bwd_dkv.argtypes = [
        i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p, f, i, i, i, i, p]
    lib.rtt_flash_bwd_dkv.restype = i
    lib.rtt_flash_bwd_tile_rows.argtypes = [i, i, i]
    lib.rtt_flash_bwd_tile_rows.restype = i
    lib.rtt_flash_bwd_dkv_blocks_per_sm.argtypes = [i, i, p]
    lib.rtt_flash_bwd_dkv_blocks_per_sm.restype = i
    lib.rtt_wgmma_probe.argtypes = [p, p, p, p, p, i, p]
    lib.rtt_wgmma_probe.restype = i
    lib.rtt_paged_decode.argtypes = [
        i, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p, i, p, p]
    lib.rtt_paged_decode.restype = i
    lib.rtt_error_string.argtypes = [i]
    lib.rtt_error_string.restype = ctypes.c_char_p


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    _declare(lib)
    return lib


def library() -> ctypes.CDLL:
    """The kernels' library, built on first use (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def check(lib: ctypes.CDLL, code: int, kernel: str) -> None:
    if code != 0:
        msg = lib.rtt_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code}: {msg}")


def current_stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
