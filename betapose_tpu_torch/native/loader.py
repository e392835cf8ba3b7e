"""ctypes bindings for the native frame loader (`loader.cpp`).

A copy of the JAX package's `native/loader`: an ordered ring of PNG/JPEG
decodes on C++ threads, linked against the system libpng16/libjpeg.
`available()` gates every caller: without g++ or the codec libraries the
cv2 `data.loader.PrefetchLoader` stays the feed, so the native loader is
an acceleration, never a requirement.

`build_native` compiles with g++ into `betapose_tpu_torch/_build/` (listed
in `.gitignore`), named by a hash of the source and the flags, so a
changed source is rebuilt and an unchanged one reused.  Nothing is built
when the module is imported: the first call that needs the library does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "loader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
LINK_FLAGS = ("-lpng16", "-ljpeg", "-pthread")

_lib = None
_build_failed = False
_lock = threading.Lock()

BP_ERRORS = {
    -1: "cannot open file",
    -2: "not a PNG or JPEG",
    -3: "codec failure",
    -4: "buffer too small or frame dims mismatch",
}


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(GXX_FLAGS + LINK_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libbploader-{digest.hexdigest()[:16]}.so")


def build_native(force: bool = False) -> str | None:
    """Compile loader.cpp to its shared library. Returns its path, or None
    when there is no C++ compiler or the build fails (its errors go to
    stderr)."""
    lib = library_path()
    if os.path.exists(lib) and not force:
        return lib
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    # a per-process temp path renamed into place: concurrent builds never
    # leave a half-written library for another process to load
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [gxx, *GXX_FLAGS, "-o", tmp, _SRC, *LINK_FLAGS]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, lib)
    except subprocess.CalledProcessError as e:
        sys.stderr.write(e.stderr.decode())
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = build_native()
        if path is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(path)
        lib.bp_imread_rgb.restype = ctypes.c_int
        lib.bp_imread_rgb.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.bp_loader_create.restype = ctypes.c_void_p
        lib.bp_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.bp_loader_next.restype = ctypes.c_int
        lib.bp_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.bp_loader_error.restype = ctypes.c_int
        lib.bp_loader_error.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.bp_loader_destroy.restype = None
        lib.bp_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def probe_dims(path: str) -> tuple[int, int]:
    """(height, width) from the image header, no pixel decode."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.bp_imread_rgb(path.encode(), None, 0,
                           ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"{BP_ERRORS.get(rc, rc)}: {path}")
    return h.value, w.value


def imread_rgb(path: str) -> np.ndarray:
    """Decode one PNG/JPEG to RGB uint8 HWC via the native codecs."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    h, w = probe_dims(path)
    out = np.empty((h, w, 3), np.uint8)
    hh = ctypes.c_int()
    ww = ctypes.c_int()
    rc = lib.bp_imread_rgb(
        path.encode(), out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
        ctypes.byref(hh), ctypes.byref(ww))
    if rc != 0:
        raise IOError(f"{BP_ERRORS.get(rc, rc)}: {path}")
    return out


def _parse_rc(msg: str) -> int:
    """The BP_ERR code of a worker error message ('decode failed (rc=-3):
    path'); 0 when absent."""
    m = re.search(r"rc=(-?\d+)", msg)
    return int(m.group(1)) if m else 0


class NativeLoader:
    """Drop-in for `data.loader.PrefetchLoader`: iterate [B,H,W,3] uint8
    batches in path order, the tail batch padded by repeating the last
    frame, `batch_sizes` recording the true counts.

    The decodes run on C++ threads writing into a bounded ring; Python
    makes one ctypes call and one buffer allocation per batch.  Frame dims
    are probed from the first file and enforced for all frames (mixed
    sizes raise, as np.stack would in the Python loader).  `fallbacks`
    counts the runs that handed their remaining frames to the cv2 pool.
    """

    def __init__(self, paths, batch_size: int, workers: int = 8,
                 lookahead: int = 3):
        self.paths = [os.fspath(p) for p in paths]
        self.batch_size = batch_size
        self.workers = workers
        self.lookahead = lookahead
        n = len(self.paths)
        self.num_batches = (n + batch_size - 1) // batch_size
        self.batch_sizes = [
            min(batch_size, n - i * batch_size) for i in range(self.num_batches)]
        if n == 0:
            raise ValueError("NativeLoader needs at least one path")
        self.height, self.width = probe_dims(self.paths[0])
        self.fallbacks = 0

    def __len__(self):
        return self.num_batches

    def __iter__(self):
        lib = _load()
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        window = max(2, self.lookahead) * self.batch_size
        handle = lib.bp_loader_create(arr, len(self.paths), self.height,
                                      self.width, self.workers, window)
        if not handle:
            raise RuntimeError("bp_loader_create failed")
        fail_msg = None
        fail_batch = 0
        try:
            for bi in range(self.num_batches):
                out = np.empty(
                    (self.batch_size, self.height, self.width, 3), np.uint8)
                got = lib.bp_loader_next(
                    handle, out.ctypes.data_as(ctypes.c_void_p),
                    self.batch_size)
                if got < 0:
                    buf = ctypes.create_string_buffer(512)
                    lib.bp_loader_error(handle, buf, 512)
                    msg = buf.value.decode() or "native decode failed"
                    if _parse_rc(msg) in (-2, -3):   # codec-class: cv2 may
                        fail_msg = msg               # still decode it
                        fail_batch = bi
                        break
                    raise IOError(msg)   # missing file / dims mismatch:
                                         # cv2 cannot fix those either
                if got != self.batch_sizes[bi]:
                    raise RuntimeError(
                        f"loader returned {got} frames, expected "
                        f"{self.batch_sizes[bi]}")
                yield out
        finally:
            lib.bp_loader_destroy(handle)
        if fail_msg is not None:
            # A subformat the native codecs reject (CMYK JPEG, 16-bit or
            # exotic-palette PNG, ...) may still decode in cv2: an input
            # set that works with the cv2 loader keeps working, so the
            # remaining frames go to the cv2 pool instead of aborting the
            # run.  Unreadable files still raise, from cv2's decode.
            sys.stderr.write(
                f"WARNING: native loader failed ({fail_msg}); falling "
                "back to the cv2 loader for the remaining frames\n")
            self.fallbacks += 1
            from ..data.loader import PrefetchLoader
            tail = PrefetchLoader(
                self.paths[fail_batch * self.batch_size:],
                self.batch_size, self.workers, self.lookahead)
            yield from tail
