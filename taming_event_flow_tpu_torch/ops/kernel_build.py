"""Build and load the hand-written CUDA kernels (``csrc/warp_kernels.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with :mod:`ctypes` (no PyTorch headers,
so it builds in seconds: ``chip_smoke.py`` prints the build time, and
PERF.md records it). The build happens at first CUDA use, into
``build/cuda/<source hash>/`` beside the package (a directory ``.gitignore``
lists), so a fresh checkout builds everything it runs from its own sources
and a changed source never loads a stale library.
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

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "warp_kernels.cu")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "cuda")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded = []  # the process's one KernelLibrary, once built


class KernelLibrary:
    """A loaded kernel library and what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: str, seconds: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = seconds  # 0.0 when the library was cached
        self.build_log = log  # nvcc's -Xptxas -v report (registers, spills)


def _nvcc() -> str:
    for cand in (os.path.join("/usr/local/cuda", "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from csrc/ at first "
        "CUDA use and need the CUDA toolkit")


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("tef_splat_bilinear", "tef_gather_bilinear"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
    lib.tef_gather_fused.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.tef_gather_fused.restype = i32
    lib.tef_row_gather.argtypes = [ptr, ptr, ptr, ctypes.c_int64, i32, i32,
                                   ptr]
    lib.tef_row_gather.restype = i32
    lib.tef_error_string.argtypes = [i32]
    lib.tef_error_string.restype = ctypes.c_char_p


def load() -> KernelLibrary:
    """Build (if needed) and load ``csrc/warp_kernels.cu``; once per
    process."""
    with _lock:
        if _loaded:
            return _loaded[0]
        with open(SOURCE, "rb") as f:
            code = f.read()
        key = hashlib.sha256(
            code + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out_dir = os.path.join(BUILD_ROOT, key)
        so = os.path.join(out_dir, "warp_kernels.so")
        seconds, log = 0.0, ""
        if not os.path.exists(so):
            os.makedirs(out_dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                capture_output=True, text=True,
            )
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed for {SOURCE}:\n{log}")
            os.replace(tmp, so)  # atomic: concurrent builders agree
        lib = ctypes.CDLL(so)
        _declare(lib)
        _loaded.append(KernelLibrary(lib, so, seconds, log))
        return _loaded[0]
