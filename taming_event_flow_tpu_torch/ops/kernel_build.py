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
import re
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
    lib.tef_gather_fused.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.tef_gather_fused.restype = i32
    lib.tef_row_gather.argtypes = [ptr, ptr, ptr, ctypes.c_int64, i32, i32,
                                   ptr]
    lib.tef_row_gather.restype = i32
    lib.tef_error_string.argtypes = [i32]
    lib.tef_error_string.restype = ctypes.c_char_p


def compile_library(source: str, so: str):
    """Compile ``source`` with nvcc into the shared library ``so`` (written
    atomically, so concurrent builders agree); returns ``(seconds, log)``,
    the log being ptxas's report (see :func:`ptxas_report`)."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {source}:\n{log}")
    os.replace(tmp, so)
    return seconds, log


def open_library(so: str) -> ctypes.CDLL:
    """Load a built library and declare its C entry points."""
    lib = ctypes.CDLL(so)
    _declare(lib)
    return lib


def ptxas_report(log: str):
    """Per kernel instance of a build log: ``(name, registers, spill stores
    + loads in bytes)``, the name demangled as far as ``kernel<args>``."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = entry.group(1)
            m = re.search(r"\d([a-z][a-z_]*_kernel)I(.*?)EEv", mangled)
            if m is None:
                name = mangled
            else:
                args = re.findall(r"L[ib](\d+)E", m.group(2) + "E")
                name = f"{m.group(1)}<{','.join(args) or m.group(2)}>"
        stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        if stores:
            spill = int(stores.group(1)) + int(stores.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name is not None:
            out.append((name, int(regs.group(1)), spill))
            name, spill = None, 0
    return out


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
            seconds, log = compile_library(SOURCE, so)
        _loaded.append(KernelLibrary(open_library(so), so, seconds, log))
        return _loaded[0]
