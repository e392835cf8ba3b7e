"""Host-side frame loading with background prefetch.

A copy of `betapose_tpu/data/loader.py`: the C++ ring loader
(`native/loader`), a cv2 thread pool or a cv2 process pool decodes images
ahead of the device in fixed-size uint8 batches [B,H,W,3], in path order;
`FrameCache` decodes a path list once into a memmap and serves it.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import multiprocessing as mp
import os

import numpy as np


def imread_rgb(path: str) -> np.ndarray:
    """Read an image file to RGB uint8 HWC.

    PNG/JPEG goes through the native C++ codecs when the library builds
    (byte-identical to cv2 for PNG, and RGB directly, without cv2's BGR
    detour); anything else, or a native failure (an exotic subformat, no
    toolchain), takes cv2.  cv2.cvtColor rather than a fancy-index flip
    there: the SIMD conversion is far faster."""
    if os.path.splitext(path)[1].lower() in (".png", ".jpg", ".jpeg"):
        from ..native import loader as native
        try:
            if native.available():
                return native.imread_rgb(path)
        except IOError:
            if not os.path.exists(path):
                raise FileNotFoundError(path)
            # a subformat only cv2 decodes: fall through
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def list_images(input_path: str = "", input_list: str = ""):
    """Reference entry semantics (`betapose_evaluate.py:105-113`): either an
    image directory (files only, sorted) or a newline list file."""
    if input_list:
        with open(input_list) as f:
            return [ln.strip() for ln in f if ln.strip()]
    if input_path and input_path != "/":
        for root, _dirs, files in os.walk(input_path):
            return [os.path.join(root, f) for f in sorted(files)]
        return []
    raise IOError("Error: must contain either --indir/--list")


def _decode_span(paths):
    """Decode a list of paths to one stacked array (in a worker process:
    one IPC round per span amortizes the pickling)."""
    return np.stack([imread_rgb(p) for p in paths])


class PrefetchLoader:
    """Iterate fixed-size uint8 frame batches [B,H,W,3] with lookahead.

    The last batch is padded by repeating the final frame; `batch_sizes`
    records the true counts so the consumer can trim.  use_processes=True
    decodes in a spawned process pool (spawn, not fork: the parent holds
    torch and CUDA threads)."""

    def __init__(self, paths, batch_size: int, workers: int = 8,
                 lookahead: int = 3, use_processes: bool = False,
                 span: int = 8):
        self.paths = list(paths)
        self.batch_size = batch_size
        self.workers = workers
        self.lookahead = lookahead
        self.use_processes = use_processes
        self.span = max(1, span)
        n = len(self.paths)
        self.num_batches = (n + batch_size - 1) // batch_size
        self.batch_sizes = [
            min(batch_size, n - i * batch_size) for i in range(self.num_batches)]

    def __len__(self):
        return self.num_batches

    def _iter_threads(self):
        """Per-frame decode futures (cv2 releases the GIL) assembled into
        batches in order, within a `lookahead`-batches window."""
        n = len(self.paths)
        window = max(1, self.lookahead) * self.batch_size
        with cf.ThreadPoolExecutor(self.workers) as pool:
            futures = {}
            submitted = 0

            def fill(upto):
                nonlocal submitted
                while submitted < min(upto, n):
                    futures[submitted] = pool.submit(
                        imread_rgb, self.paths[submitted])
                    submitted += 1

            fill(window)
            for bi in range(self.num_batches):
                start = bi * self.batch_size
                count = self.batch_sizes[bi]
                fill(start + count + window)
                frames = [futures.pop(start + j).result()
                          for j in range(count)]
                while len(frames) < self.batch_size:   # pad tail batch
                    frames.append(frames[-1])
                yield np.stack(frames)

    def _iter_processes(self):
        """Span-granular decode futures over a process pool, assembled into
        batches in order with the same lookahead window."""
        n = len(self.paths)
        spans = [(s, min(s + self.span, n)) for s in range(0, n, self.span)]
        window_spans = max(
            1, (max(1, self.lookahead) * self.batch_size) // self.span)
        with cf.ProcessPoolExecutor(
                self.workers, mp_context=mp.get_context("spawn")) as pool:
            futures = {}
            submitted = 0

            def fill(upto_span):
                nonlocal submitted
                while submitted < min(upto_span, len(spans)):
                    s, e = spans[submitted]
                    futures[submitted] = pool.submit(
                        _decode_span, self.paths[s:e])
                    submitted += 1

            fill(window_spans)
            chunks: list[np.ndarray] = []
            have = 0
            next_span = 0
            for bi in range(self.num_batches):
                count = self.batch_sizes[bi]
                while have < count:
                    fill(next_span + 1 + window_spans)
                    arr = futures.pop(next_span).result()
                    next_span += 1
                    chunks.append(arr)
                    have += len(arr)
                flat = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
                batch, rest = flat[:count], flat[count:]
                chunks = [rest] if len(rest) else []
                have = len(rest)
                if count < self.batch_size:            # pad tail batch
                    pad = np.repeat(batch[-1:], self.batch_size - count, 0)
                    batch = np.concatenate([batch, pad])
                yield batch

    def __iter__(self):
        if self.use_processes:
            return self._iter_processes()
        return self._iter_threads()


def make_loader(paths, batch_size: int, mode: str = "auto",
                workers: int = 8, lookahead: int = 3):
    """Select the host feed backend; every backend yields padded
    [B,H,W,3] uint8 batches in path order with a `batch_sizes` list.

    mode:
      - "native": the C++ libpng/libjpeg ring loader (`native/loader.cpp`),
        decoding off the GIL on `workers` threads; raises when the
        library cannot build (no g++ or codec headers).
      - "threads" / "procs": the cv2 pools (PrefetchLoader).
      - "auto": native when it builds and every input is a .png/.jpg/.jpeg
        (the native codecs' scope), cv2 threads otherwise.  A codec-class
        failure partway through a run (a subformat libpng/libjpeg rejects
        and cv2 accepts, such as a CMYK JPEG) hands the remaining frames
        to the cv2 pool instead of aborting.
    """
    paths = list(paths)
    if mode not in ("auto", "native", "threads", "procs"):
        raise ValueError(f"unknown host_loader mode {mode!r}")
    if mode in ("auto", "native"):
        from ..native import loader as native
        if mode == "native":
            if not native.available():
                raise RuntimeError(
                    "--host_loader native: C++ loader unavailable "
                    "(no g++ or libpng/libjpeg)")
            return native.NativeLoader(paths, batch_size, workers, lookahead)
        exts_ok = paths and all(
            os.path.splitext(p)[1].lower() in (".png", ".jpg", ".jpeg")
            for p in paths)
        if exts_ok and native.available():
            return native.NativeLoader(paths, batch_size, workers, lookahead)
    return PrefetchLoader(paths, batch_size, workers, lookahead,
                          use_processes=(mode == "procs"))


class FrameCache:
    """Pre-decoded frames: decode a path list once into a uint8 memmap
    (.npy), then serve batches at disk or page-cache bandwidth.  For hosts
    whose decode cannot keep up with the device, and for loops over a
    fixed eval set.  A `.manifest.json` beside the cache pins the exact
    (path, size) list it was built from."""

    def __init__(self, paths, cache_path: str, workers: int = 8):
        self.paths = list(paths)
        self.cache_path = cache_path
        if not os.path.exists(cache_path):
            self._build(workers)
        self.frames = np.load(cache_path, mmap_mode="r")
        if len(self.frames) != len(self.paths):
            raise ValueError(
                f"cache {cache_path} holds {len(self.frames)} frames but "
                f"{len(self.paths)} paths were given — delete the stale "
                "cache or pass the original path list")
        # a frame-count match is not identity: a cache of a reordered or
        # different list of the same length would serve the wrong frames
        manifest = self._manifest_path()
        if not os.path.exists(manifest):
            raise ValueError(
                f"cache {cache_path} has no manifest ({manifest}) — built "
                "by an older version or trimmed by hand; delete the cache "
                "to rebuild it")
        with open(manifest) as f:
            recorded = json.load(f)
        if recorded != self._manifest_entries():
            raise ValueError(
                f"cache {cache_path} was built from a different path list "
                "(manifest mismatch) — delete the stale cache or pass the "
                "original path list")

    def _manifest_path(self):
        return self.cache_path + ".manifest.json"

    def _manifest_entries(self):
        return [[p, os.path.getsize(p)] for p in self.paths]

    def _build(self, workers):
        first = imread_rgb(self.paths[0])
        shape = (len(self.paths),) + first.shape
        arr = np.lib.format.open_memmap(
            self.cache_path, mode="w+", dtype=np.uint8, shape=shape)
        arr[0] = first
        with cf.ThreadPoolExecutor(workers) as pool:
            def put(i):
                arr[i] = imread_rgb(self.paths[i])
            list(pool.map(put, range(1, len(self.paths))))
        arr.flush()
        with open(self._manifest_path(), "w") as f:
            json.dump(self._manifest_entries(), f)

    def batches(self, batch_size: int):
        """Yield [B,H,W,3] uint8 batches (the tail padded as PrefetchLoader
        pads it; the caller trims)."""
        n = len(self.frames)
        for s in range(0, n, batch_size):
            batch = np.asarray(self.frames[s:s + batch_size])
            if len(batch) < batch_size:
                pad = np.repeat(batch[-1:], batch_size - len(batch), 0)
                batch = np.concatenate([batch, pad])
            yield batch
