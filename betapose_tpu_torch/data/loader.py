"""Host-side frame loading with background prefetch.

Counterpart of the cv2 paths of `betapose_tpu/data/loader.py`: a thread
pool (or a process pool) decodes images ahead of the device in fixed-size
uint8 batches [B,H,W,3], in path order.  The C++ ring loader
(`betapose_tpu/native/`) is not ported yet: `mode="native"` raises and
`mode="auto"` takes the cv2 threads.
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing as mp
import os

import numpy as np


def imread_rgb(path: str) -> np.ndarray:
    """Read an image file to RGB uint8 HWC (cv2.cvtColor: the SIMD
    conversion is far faster than a fancy-index flip)."""
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
    """Select the host feed backend: "threads" or "auto" (cv2 thread pool),
    "procs" (cv2 process pool).  "native" raises until the C++ loader is
    ported."""
    if mode == "native":
        raise NotImplementedError(
            "--host_loader native: the C++ ring loader is not ported yet "
            "(ROADMAP); use threads or procs")
    if mode not in ("auto", "threads", "procs"):
        raise ValueError(f"unknown host_loader mode {mode!r}")
    return PrefetchLoader(paths, batch_size, workers, lookahead,
                          use_processes=(mode == "procs"))
