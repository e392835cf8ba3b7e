"""Host-feed scaling probe: decode frames/s as a function of worker count.

A copy of the JAX package's `tools/probe_feed`.  The reference feeds
darknet from a 16-thread CPU loader (`data.c:912-949` load_threads fans
load_args across `args.threads=16` pthreads) and torch DataLoaders
(`KPD/src/train.py` num_workers); the port's counterparts are
`data/loader.py`'s cv2 pools and the C++ ring loader (`native/loader.cpp`).
On one NVIDIA H100 80GB HBM3 at 700 W the capacity-1 pose step at batch 8
consumes 130.7-161.0 frames/s of frames already in memory (`chip_smoke.py`,
PERF.md section 5), so what a host must decode to keep the card fed is a
measured number, not an assumption: the probe measures the curve wherever
it runs.

    python -m betapose_tpu_torch.tools.probe_feed [--workers 1,2,4,8]
        [--frames 96] [--batch 16] [--loader native,threads]

prints one JSON line {loader: {workers: fps}} plus the per-core estimate.

Expected shape: fps(N) ~= fps(1) * min(N, physical cores), saturating when
decode outpaces the consumer (ring slots) or memory bandwidth; on a 1-core
host every N ties fps(1) within noise (a drop of more than 15% at N=8
would flag contention in the ring).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np


def make_png_pool(pool_dir, n_frames, rng=None, hw=(480, 640)):
    """Synthetic LineMod-like PNGs (textured blobs + sensor noise): PNG
    entropy like a camera frame's, so the decode cost is representative."""
    import cv2
    rng = rng or np.random.default_rng(0)
    h, w = hw
    base = np.zeros((h, w, 3), np.uint8)
    for _ in range(25):
        c = tuple(int(v) for v in rng.integers(0, 255, 3))
        cv2.circle(base, (int(rng.integers(0, w)), int(rng.integers(0, h))),
                   int(rng.integers(10, 90)), c, -1)
    base = cv2.GaussianBlur(base, (5, 5), 1.5)
    paths = []
    for i in range(n_frames):
        noise = rng.integers(-6, 7, (h, w, 3)).astype(np.int16)
        img = np.clip(base.astype(np.int16) + noise, 0, 255).astype(np.uint8)
        p = os.path.join(pool_dir, f"{i:06d}.png")
        cv2.imwrite(p, img)
        paths.append(p)
    return paths


def _drain(loader):
    n = 0
    for fr in loader:
        n += len(fr)
    return n


def measure_scaling(paths, batch, workers_list, loader="native"):
    """fps at each worker count for one loader kind.  Returns
    {workers: fps} (floats), or None if the kind is unavailable."""
    from ..data.loader import PrefetchLoader
    mk = None
    if loader == "native":
        from ..native import loader as native_mod
        if not native_mod.available():
            return None
        mk = lambda w: native_mod.NativeLoader(paths, batch, workers=w)
    elif loader == "threads":
        mk = lambda w: PrefetchLoader(paths, batch, workers=w)
    elif loader == "procs":
        mk = lambda w: PrefetchLoader(paths, batch, workers=w,
                                      use_processes=True)
    else:
        raise ValueError(f"unknown loader kind {loader!r}")

    _drain(mk(workers_list[0]))          # warm: page cache + lib load
    out = {}
    for w in workers_list:
        t0 = time.perf_counter()
        n = _drain(mk(w))
        out[int(w)] = n / (time.perf_counter() - t0)
    return out


def run_probe(workers_list=(1, 2, 4, 8), frames=96, batch=16,
              loaders=("native", "threads"), pool_dir=None):
    """Returns the probe dict."""
    tmp = None
    if pool_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="feed_probe_")
        pool_dir = tmp.name
    try:
        paths = make_png_pool(pool_dir, frames)
        curves = {}
        for kind in loaders:
            c = measure_scaling(paths, batch, list(workers_list), kind)
            if c is not None:
                curves[kind] = {str(k): round(v, 2) for k, v in c.items()}
        best = {k: max(v.values()) for k, v in curves.items()}
        per_core = None
        if "native" in curves:
            per_core = curves["native"].get("1")
        return {
            "host_cpus": os.cpu_count(),
            "frames": frames,
            "curves": curves,
            "per_core_native_fps": per_core,
            "expected": "fps(N) ~= fps(1) * min(N, host_cpus); see "
                        "betapose_tpu_torch/tools/probe_feed.py docstring",
            "best_fps": round(max(best.values()), 2) if best else None,
        }
    finally:
        if tmp is not None:
            tmp.cleanup()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workers", default="1,2,4,8")
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--loader", default="native,threads",
                    help="comma list of native,threads,procs")
    args = ap.parse_args(argv)
    res = run_probe(tuple(int(w) for w in args.workers.split(",")),
                    args.frames, args.batch,
                    tuple(args.loader.split(",")))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
