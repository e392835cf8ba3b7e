"""The fast selftest tier over several seeds, in the JAX package and in
the PyTorch port, on the CPU: the spread of its accuracy in each package.

`seed` sets the rendered scenes and the host draws of the training
batches in both packages (the weight inits are fixed).  Each run is its
own subprocess, which imports one package only; runs go `--jobs` at a
time, each limited to `--threads` CPU threads.  One JSON line per run, as
it ends (package, seed, wall seconds, the stats dict of `run_selftest`),
goes to stdout and to `--out`, then a summary line per package: mean and
spread of mean ADD, ADD<0.1d and n_detected.

`--train_precision` goes to `run_selftest` in both packages.  Compare the
packages on the CPU at `float32`: XLA:CPU ignores the JAX package's
`"bfloat16"` matmul precision (its convs there are the float32 convs),
while the port's `"bfloat16"` rounds the conv operands on every device.

Run: python selftest_seeds.py --seeds 0,1,2 --jobs 3 --threads 2 \\
       --train_precision float32 --out seeds.jsonl
The port alone on the card (its runs share the one card):
     python selftest_seeds.py --packages torch --torch_device cuda \\
       --train_precision bfloat16 --out seeds_card.jsonl

`--yolo_iters` / `--kpd_iters` cut the tier's training (the detector's
IoU after N steps, say).  `--swap init,draws,kpd_init,kpd_draws` hands
the JAX package's detector init (its seeded `init_params`, as a .weights
file), its detector loop's augmentation draws (from its per-iteration key
splits), its FastPose init (an .npz) and its KPD loop's draws to the
port's runs (`run_selftest(yolo_init=, yolo_draws=, kpd_init=,
kpd_draws=)`); a JAX subprocess writes them first.
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
              "kw = {{'device': {torch_device!r}}}"),
}


# the JAX package's detector init and the draws of its detector loop (the
# fast tier's: PRNGKey(3) split once per iteration, then per sample as its
# augment_detection_batch splits it), written for the port to replay
SWAP_CODE = """
import jax, numpy as np
jax.config.update('jax_platforms', 'cpu')
from betapose_tpu.models import yolov3 as ym
from betapose_tpu.tools.selftest import YOLO_CFG
from betapose_tpu.train.yolo_train import YoloTrainConfig
spec = ym.build_spec(YOLO_CFG.format(reso=192))
ym.save_darknet_weights(spec, jax.device_get(
    ym.init_params(jax.random.PRNGKey(0), spec)), {init!r})
cfg = YoloTrainConfig()
dw, dh = cfg.jitter * 640, cfg.jitter * 480
u = jax.random.uniform
def one(k):
    k1, k2 = jax.random.split(k)
    c, s = jax.random.split(k1, 5), jax.random.split(k2, 5)
    return dict(pleft=u(c[0], minval=-dw, maxval=dw),
                pright=u(c[1], minval=-dw, maxval=dw),
                ptop=u(c[2], minval=-dh, maxval=dh),
                pbot=u(c[3], minval=-dh, maxval=dh), flip_u=u(c[4]),
                dhue=u(s[0], minval=-cfg.hue, maxval=cfg.hue),
                sat_s=u(s[1], minval=1.0, maxval=cfg.saturation),
                sat_u=u(s[2]),
                exp_s=u(s[3], minval=1.0, maxval=cfg.exposure),
                exp_u=u(s[4]))
batch = jax.jit(lambda k: jax.vmap(one)(jax.random.split(k, 16)))
key, rows = jax.random.PRNGKey(3), []
for _ in range({iters}):
    key, k1 = jax.random.split(key)
    rows.append(batch(k1))
np.savez({draws!r}, **{{n: np.stack([np.asarray(r[n]) for r in rows])
                       for n in rows[0]}})

# the KPD loop's: FastPose-resnet50 (12 keypoints) from PRNGKey(1), and
# PRNGKey(2) split once per iteration, then per sample into 12 keys
from betapose_tpu.core.checkpoint import save_pytree_npz
from betapose_tpu.models import kpd as km
from betapose_tpu.train.augment import AugmentConfig
save_pytree_npz({kpd_init!r}, jax.device_get(km.init_params(
    jax.random.PRNGKey(1), n_classes=12, arch="resnet50")))
acfg = AugmentConfig()
def kone(k):
    k = jax.random.split(k, 12)
    return dict(jit3=u(k[0], (3,), minval=0.7, maxval=1.3),
                rate=u(k[1], minval=acfg.scale_min, maxval=acfg.scale_max),
                patch_scale=u(k[2]),
                patch_u=jax.numpy.stack([u(k[3]), u(k[4])]),
                gauss=jax.random.normal(k[5], (4,)), switch=u(k[6]),
                flip_u=u(k[7]), rot_n=jax.random.normal(k[8]),
                rot_u=u(k[9]))
kbatch = jax.jit(lambda k: jax.vmap(kone)(jax.random.split(k, 8)))
key, rows = jax.random.PRNGKey(2), []
for _ in range({kpd_iters}):
    key, k1 = jax.random.split(key)
    rows.append(kbatch(k1))
np.savez({kpd_draws!r}, **{{n: np.stack([np.asarray(r[n]) for r in rows])
                           for n in rows[0]}})
"""

SWAPS = ("init", "draws", "kpd_init", "kpd_draws")


def write_swap(out_dir, iters, kpd_iters=1500):
    """The JAX package's detector and KPD inits and loop draws, for at
    least `iters` / `kpd_iters` iterations: {swap name: path}, the keys
    of SWAPS.  Files already in `out_dir` that cover both are reused."""
    os.makedirs(out_dir, exist_ok=True)
    paths = dict(zip(SWAPS, (os.path.join(out_dir, f) for f in (
        "jax_yolo_init.weights", "jax_yolo_draws.npz", "jax_kpd_init.npz",
        "jax_kpd_draws.npz"))))
    if all(os.path.exists(p) for p in paths.values()):
        with np.load(paths["draws"]) as z, np.load(paths["kpd_draws"]) as k:
            if len(z["pleft"]) >= iters and len(k["rate"]) >= kpd_iters:
                return paths
    code = SWAP_CODE.format(init=paths["init"], draws=paths["draws"],
                            iters=iters, kpd_init=paths["kpd_init"],
                            kpd_draws=paths["kpd_draws"], kpd_iters=kpd_iters)
    proc = subprocess.run(
        [sys.executable, "-c", code], env=dict(os.environ,
                                                JAX_PLATFORMS="cpu"),
        capture_output=True, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode:
        raise RuntimeError(f"writing the JAX inits and draws failed:\n"
                           f"{proc.stderr[-4000:]}")
    return paths


def run_one(package, seed, threads, train_precision="bfloat16",
            torch_device="cpu", tier=None, swap=None):
    """One run in a subprocess.  tier: run_selftest overrides (both
    packages); swap: run_selftest keywords for the port only."""
    extra = dict(tier or {})
    if package == "torch":
        extra.update(swap or {})
    code = (RUNNERS[package].format(threads=threads,
                                    torch_device=torch_device)
            + "; import json; "
            f"s = run_selftest(seed={seed}, verbose=False, "
            f"train_precision={train_precision!r}, **kw, **{extra!r}); "
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
    return {"package": package, "seed": seed,
            "train_precision": train_precision,
            "device": torch_device if package == "torch" else "cpu",
            "tier": tier or {},
            "swap": sorted(swap or {}) if package == "torch" else [],
            "wall_s": wall,
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
    p.add_argument("--train_precision", default="bfloat16",
                   choices=["bfloat16", "tensorfloat32", "float32"],
                   help="run_selftest's train_precision, in both packages")
    p.add_argument("--torch_device", default="cpu", choices=["cpu", "cuda"],
                   help="the port's device (the JAX package runs on the CPU)")
    p.add_argument("--yolo_iters", type=int, default=None)
    p.add_argument("--kpd_iters", type=int, default=None)
    p.add_argument("--swap", default="",
                   help="comma list of init,draws,kpd_init,kpd_draws: the "
                        "JAX package's detector init / loop draws, KPD "
                        "init / loop draws in the port's runs")
    p.add_argument("--swap_dir", default="exp/selftest_swap",
                   help="where the JAX init and draws are written")
    p.add_argument("--out", default=None,
                   help="append the JSON lines to this file as well")
    args = p.parse_args(argv)
    tier = {k: getattr(args, k) for k in ("yolo_iters", "kpd_iters")
            if getattr(args, k) is not None}
    wanted = [w for w in args.swap.split(",") if w]
    if set(wanted) - set(SWAPS):
        p.error(f"--swap takes {','.join(SWAPS)}, not {args.swap!r}")
    swap = {}
    if wanted:
        paths = write_swap(args.swap_dir, max(250, tier.get("yolo_iters", 0)),
                           max(1500, tier.get("kpd_iters", 0)))
        keyword = {"init": "yolo_init", "draws": "yolo_draws",
                   "kpd_init": "kpd_init", "kpd_draws": "kpd_draws"}
        swap = {keyword[w]: os.path.abspath(paths[w]) for w in wanted}
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
        futs = {pool.submit(run_one, pkg, s, args.threads,
                            args.train_precision, args.torch_device, tier,
                            swap): (pkg, s)
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
