"""The fast selftest tier over several seeds, in the JAX package and in
the PyTorch port, on the CPU: the spread of its accuracy in each package.

`seed` sets the rendered scenes and the host draws of the training
batches in both packages (the weight inits are fixed).  Each run is its
own subprocess, which imports one package only; runs go `--jobs` at a
time, each limited to `--threads` CPU threads.  One JSON line per run, as
it ends (package, seed, wall seconds, the stats dict of `run_selftest`),
goes to stdout and to `--out`, then a summary line per package: mean and
spread of mean ADD, ADD<0.1d and n_detected.

Run: python selftest_seeds.py --seeds 0,1,2 --jobs 3 --threads 2 \\
       --out seeds.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor, as_completed

import numpy as np

RUNNERS = {
    "jax": ("import jax; jax.config.update('jax_platforms', 'cpu'); "
            "from betapose_tpu.tools.selftest import run_selftest; "
            "kw = {{}}"),
    "torch": ("import torch; torch.set_num_threads({threads}); "
              "from betapose_tpu_torch.tools.selftest import run_selftest; "
              "kw = {{'device': 'cpu'}}"),
}


def run_one(package, seed, threads):
    code = (RUNNERS[package].format(threads=threads) + "; import json; "
            f"s = run_selftest(seed={seed}, verbose=False, **kw); "
            "print('STATS ' + json.dumps(s))")
    env = dict(os.environ, OMP_NUM_THREADS=str(threads),
               MKL_NUM_THREADS=str(threads), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         f"intra_op_parallelism_threads={threads}")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("STATS ")]
    if proc.returncode or not lines:
        raise RuntimeError(f"{package} seed {seed} failed "
                           f"(rc {proc.returncode}):\n{proc.stderr[-4000:]}")
    return {"package": package, "seed": seed, "wall_s": wall,
            "stats": json.loads(lines[-1][len("STATS "):])}


def summary(rows):
    out = {}
    for pkg in sorted({r["package"] for r in rows}):
        st = [r["stats"] for r in rows if r["package"] == pkg]
        add = np.array([s["mean_add_m"] for s in st])
        out[pkg] = {
            "seeds": [r["seed"] for r in rows if r["package"] == pkg],
            "mean_add_m": add.tolist(),
            "mean_add_m_mean": float(add.mean()),
            "mean_add_m_min": float(add.min()),
            "mean_add_m_max": float(add.max()),
            "add_01d_acc": [s["add_01d_acc"] for s in st],
            "median_add_m": [s["median_add_m"] for s in st],
            "mean_2d_px": [s["mean_2d_px"] for s in st],
            "n_detected": [s["n_detected"] for s in st],
            "mean_iou": [s["mean_iou"] for s in st]}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--packages", default="jax,torch")
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--jobs", type=int, default=3)
    p.add_argument("--threads", type=int, default=2)
    p.add_argument("--out", default=None,
                   help="append the JSON lines to this file as well")
    args = p.parse_args(argv)
    runs = [(pkg, int(s)) for s in args.seeds.split(",")
            for pkg in args.packages.split(",")]
    rows = []

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    failed = []
    with ThreadPoolExecutor(args.jobs) as pool:
        futs = {pool.submit(run_one, pkg, s, args.threads): (pkg, s)
                for pkg, s in runs}
        for fut in as_completed(futs):
            try:
                row = fut.result()
            except RuntimeError as e:
                failed.append(futs[fut])
                print(e, file=sys.stderr)
                continue
            rows.append(row)
            emit(row)
    rows.sort(key=lambda r: (r["package"], r["seed"]))
    emit({"summary": summary(rows), "failed": failed})
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
