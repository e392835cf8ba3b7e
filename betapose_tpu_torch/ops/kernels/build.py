"""Build and load the hand-written CUDA kernels of `csrc/`.

Each source is compiled by `nvcc` into a shared library with a plain C
interface and loaded with `ctypes` (no PyTorch headers, so a build takes
seconds).  Libraries go to `betapose_tpu_torch/_build/` (listed in
`.gitignore`), named by a hash of the source and the flags, so a changed
source is rebuilt and an unchanged one is reused.  Nothing is built when a
module is imported: the first launch builds, or `build_all()` builds every
source at once, one `nvcc` process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# every kernel source of the package; build_all() compiles these
SOURCES = ("heatmap_decode.cu", "bottleneck_chain.cu")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels are built at first use")
    return found


def library_path(source: str) -> str:
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def _start(source: str):
    """Start nvcc for `source` unless its library exists; returns
    (process or None, temp path, final path)."""
    lib = library_path(source)
    if os.path.exists(lib):
        return None, None, lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(source: str, proc, tmp: str, lib: str) -> str:
    """Wait for nvcc; returns its output (ptxas register/spill report)."""
    if proc is None:
        return ""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{out}")
    os.replace(tmp, lib)
    return out


def build_all() -> dict[str, str]:
    """Compile every source in parallel; returns {source: nvcc output}."""
    with _lock:
        started = [(s, *_start(s)) for s in SOURCES]
        return {s: _finish(s, p, t, lib) for s, p, t, lib in started}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, built first if needed.  The source
    is hashed once per process: a launch after the first costs a dict
    lookup."""
    lib = _loaded.get(source)
    if lib is not None:
        return lib
    with _lock:
        if source not in _loaded:
            path = library_path(source)
            _finish(source, *_start(source))
            _loaded[source] = ctypes.CDLL(path)
        return _loaded[source]
