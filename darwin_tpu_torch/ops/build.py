"""Build and load the CUDA kernels at first use.

``nvcc`` compiles ``csrc/*.cu`` by hand — one ``nvcc -c`` per source, all
started together, then one link — into a shared library with a plain C
interface (``csrc/gact.h``; ``int_probe.cu`` states its own) for ``sm_90a``,
in ``darwin_tpu_torch/_build/`` (listed in .gitignore), named by a hash of
the sources and flags so a second process — the CLI in a subprocess, say —
loads the library the first one built.  The library is bound with ctypes
and explicit argtypes; every entry point returns ``cudaGetLastError()`` and
the wrappers (``ops/gact_cuda``, ``tools/vpu_probe``) raise when it is not 0.

Nothing here runs at import: the CPU tests import every module on a host
with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
from concurrent.futures import ThreadPoolExecutor
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("gact_dp.cu", "gact_tb.cu", "int_probe.cu")
HEADERS = ("gact.h",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
# what the last build in this process did: library path, seconds spent in
# nvcc (0.0 when an existing library was loaded), and the compiler's
# stderr (ptxas register / shared-memory / spill report)
BUILD_INFO: dict = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/ at first use and need the CUDA toolkit")
    return path


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libgact_{h.hexdigest()[:16]}.so")


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    return proc.stderr


def _build(path: str) -> dict:
    """Compile and link; returns nvcc's seconds and its stderr."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{s}.o" for s in SOURCES]
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            logs = list(pool.map(_run, [
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC, src)]
                for src, obj in zip(SOURCES, objs)]))
        logs.append(_run([nvcc, "-shared", "-o", tmp, *objs]))
        os.replace(tmp, path)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return {"seconds": time.perf_counter() - t0, "log": "".join(logs)}


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gact_dp.argtypes = [p, p, p, p, p, i, i, i, p, i, i, i, i,
                            p, p, p, p, p]
    lib.gact_dp.restype = i
    lib.gact_dp_plan.argtypes = [i, i, p, p]
    lib.gact_dp_plan.restype = i
    lib.gact_tb.argtypes = [p, p, p, i, i, i, i, p, p, p, p]
    lib.gact_tb.restype = i
    lib.int_probe.argtypes = [p, p, i, i, p]
    lib.int_probe.restype = i


def load():
    """The kernel library, built from the checkout's sources if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        BUILD_INFO.clear()
        BUILD_INFO.update(path=path, seconds=0.0, log="")
        if not os.path.exists(path):
            BUILD_INFO.update(_build(path))
        lib = ctypes.CDLL(path)
        _bind(lib)
        _lib = lib
        return _lib

