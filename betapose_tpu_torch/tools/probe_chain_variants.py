"""Time edited copies of the bottleneck-chain kernel beside the committed one.

Each variant is `csrc/bottleneck_chain.cu` with a few text edits, each of
which must apply exactly once, so that a variant breaks loudly when the
source moves on.  The variants are built by nvcc in parallel, with the flags
of `ops/kernels/build.NVCC_FLAGS`, into `_build/variants/`, loaded with
ctypes and launched through the committed kernel's C entry point.  At each
probe shape every variant is held against the plain chain (a variant that
drops work is only timed) and timed by CUDA-graph replay between CUDA
events, in turns: the variants in order, then in reverse, so that drift
between the first and the last shows.  One JSON line per shape, variant and
turn, with the variant's tile (`bottleneck_chain_plan`).

The variants are measurement aids and never launched by the port, which
takes only the committed kernel:
- `committed`: the source as it is;
- `two_bands`: frames of 10 or more rows cut into at least two row bands
  (the 10x8 frame in 192 blocks instead of 96: twice the weight bytes);
- `no_weight_copies`: the products read whatever the weight buffers hold
  (the floor with no weight streaming; output not checked);
- `kc32_s4`: 32-deep pipeline steps in 4 buffers (the same 32 KB of
  weight buffers per block);
- `stages11`: 11 buffers of 16-deep steps (more weight bytes in flight,
  smaller tiles where they do not fit).

Run on the card:
    python -m betapose_tpu_torch.tools.probe_chain_variants
        [--variants committed,two_bands] [--batch 96] [--reps 10]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from betapose_tpu_torch.core.profiling import chain_ms
from betapose_tpu_torch.ops.kernels import bottleneck_chain as bc
from betapose_tpu_torch.ops.kernels import build
from betapose_tpu_torch.tools import probe_vmem_chain as pvc

# name -> (text edits, whether the output is held against the plain chain)
VARIANTS = {
    "committed": ([], True),
    "two_bands": ([("for (int rb = 1; rb <= h; ++rb) {",
                    "for (int rb = h >= 10 ? 2 : 1; rb <= h; ++rb) {")],
                  True),
    "no_weight_copies": ([(
        "    stage_weights(wbuf + buf * kWHalf, s.w + c.tap * s.tap_stride, "
        "s.k, s.m,\n                  k0, c.pass * kMB + g * 64);\n", "")],
        False),
    "kc32_s4": ([("constexpr int kKC = 16;", "constexpr int kKC = 32;"),
                 ("constexpr int kStages = 6;", "constexpr int kStages = 4;")],
                True),
    "stages11": ([("constexpr int kStages = 6;",
                   "constexpr int kStages = 11;")], True),
}

BAR = 2e-2          # chip_smoke's bar: max|k - p| <= BAR * max|p|


def variant_source(name, source):
    """`source` with the edits of variant `name`; raises ValueError when an
    edit does not apply exactly once."""
    for old, new in VARIANTS[name][0]:
        if source.count(old) != 1:
            raise ValueError(f"variant {name}: the edit of {old[:60]!r} "
                             f"applies {source.count(old)} times, not once")
        source = source.replace(old, new)
    return source


def build_variants(names):
    """{name: loaded library}, one nvcc per variant, all started together."""
    with open(os.path.join(build.CSRC, bc.SOURCE)) as f:
        source = f.read()
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(variant_source(name, source))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", path[:-3] + ".so",
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        lib.bottleneck_chain_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.bottleneck_chain_plan.argtypes = (
            [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)])
        libs[name] = lib
    return libs


def graph_ms(fn, reps, rounds):
    """Device ms of one call: `reps` calls captured in a CUDA graph, replayed
    between CUDA events, the median over `rounds`."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return chain_ms(graph.replay, "cuda", k=1, rounds=rounds, warmup=0) / reps


def probe_shape(libs, shape, reps, rounds, card):
    x, w1, w2, w3 = pvc.chain_inputs(*shape, "cuda")
    b, h, w, cin = x.shape
    cm = w1.shape[1]
    ref = bc.bottleneck_chain_plain(x, w1, w2, w3).float()
    y = torch.empty_like(x)
    rows = []
    order = list(libs) + list(libs)[::-1]
    for turn, name in enumerate(order):
        lib = libs[name]

        def launch(lib=lib):
            # the current stream at each call: a CUDA-graph capture runs
            # on a stream of its own
            err = lib.bottleneck_chain_launch(
                x.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
                y.data_ptr(), b, h, w, cin, cm,
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"variant {name} launch failed: {err}")

        launch()
        torch.cuda.synchronize()
        ratio = ((y.float() - ref).abs().max() / ref.abs().max()).item()
        if VARIANTS[name][1] and not ratio <= BAR:
            raise RuntimeError(f"variant {name} disagrees with the plain "
                               f"chain at {shape}: {ratio:.3g}")
        plan = (ctypes.c_int * 7)()
        lib.bottleneck_chain_plan(b, h, w, cin, cm, plan)
        ms = graph_ms(launch, reps, rounds)
        row = {"shape": "x".join(map(str, shape[:4])) + f"->cm{cm}",
               "variant": name, "turn": turn, "ms": ms,
               "tflops": bc.chain_flops(*shape) / ms / 1e9,
               "max_rel_err": ratio if VARIANTS[name][1] else None,
               "tile": [plan[0], plan[1]], "blocks": plan[2],
               "smem_bytes": plan[3], "widths": list(plan[4:7]),
               "device": card}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS")
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--reps", type=int, default=10,
                    help="calls per CUDA graph")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; known: "
                         f"{list(VARIANTS)}")
    if not torch.cuda.is_available():
        raise RuntimeError("probe_chain_variants needs a CUDA device: the "
                           "variants are CUDA kernels")
    from betapose_tpu_torch.core.device import resolve_device
    resolve_device("cuda")                  # TF32 off for the plain chain
    card = torch.cuda.get_device_name(0)
    libs = build_variants(names)
    rows = []
    for hwc in pvc.SHAPES:
        rows += probe_shape(libs, (args.batch, *hwc), args.reps, args.rounds,
                            card)
    return rows


if __name__ == "__main__":
    main()
