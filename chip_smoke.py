#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`betapose_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile-out FILE]

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. The card (name and power limit from nvidia-smi) and the torch version;
   every CUDA kernel of the package is built from `betapose_tpu_torch/csrc/`
   (one nvcc per source, all started together).
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes, on edge cases: the outputs must be bitwise equal.
3. The main path at full width: YOLOv3-416 (1 class) -> FastPose
   SE-ResNet101 (50 keypoints) -> peak decode -> PnP through
   `PosePipeline` at batch 8 of 480x640 frames, bf16 convs, seeded random
   weights with batch norm folded.  One warm-up step, then timed steps with
   the kernels' launch counts set to 0 before and read after; every kernel
   of the path must have launched once per step.  The step's own heatmaps
   go through the kernel and the plain version again, bitwise equal.
4. Small-input reference checks: the float32 pipeline on the card against
   the same pipeline on the CPU, and PnP on the card recovering planted
   poses.

Then a `{"kernels": [...]}` JSON line (per kernel: launches on the main
path, max abs error against the plain version, its time, the plain
version's time and the memory/compute bound, in ms), the card line again,
and as the last line `{"ok": true, "device": {...}}`.  --profile-out writes
a torch.profiler table of two main-path steps (device time by kernel).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor
# FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

CAM_K = [[572.4114, 0.0, 325.2611],
         [0.0, 573.57043, 242.04899],
         [0.0, 0.0, 1.0]]


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def _median_ms(torch, run, reps, rounds):
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    return statistics.median(per)


def time_ms(torch, fn, reps=50, rounds=7):
    """(device ms, eager ms) of one call.  Device: `reps` calls captured in
    a CUDA graph and replayed between CUDA events, which takes the host's
    launch cost out.  Eager: `reps` calls issued from Python.  Both are the
    median over `rounds`, after a warm-up; the inputs stay in L2 between
    calls, as the main path's freshly written heatmaps are."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def eager():
        for _ in range(reps):
            fn()
    return (_median_ms(torch, graph.replay, reps, rounds),
            _median_ms(torch, eager, reps, rounds))


def decode_cases(np, shape):
    """Edge-case heatmap stacks at `shape` = [B,K,H,W] (float32)."""
    import torch
    b, k, h, w = shape
    rng = np.random.default_rng(0)
    cases = {"random": rng.standard_normal(shape).astype(np.float32)}
    ties = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
    ties = ties.bfloat16().float().numpy()
    flat = ties.reshape(b * k, h * w)
    for row in flat:
        row[rng.choice(h * w, 3, replace=False)] = 1.0
    cases["bf16_ties"] = ties
    cases["all_negative"] = -rng.uniform(0.1, 1.0, shape).astype(np.float32)
    cases["all_zero"] = np.zeros(shape, np.float32)
    border = np.full(shape, 0.1, np.float32)
    spots = [(0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1), (0, w // 2),
             (h - 1, w // 2), (h // 2, 0), (h // 2, w - 1), (1, 1)]
    for m in range(b * k):
        y, x = spots[m % len(spots)]
        border.reshape(b * k, h, w)[m, y, x] = 2.0
        if 0 < x < w - 1:
            border.reshape(b * k, h, w)[m, y, x + 1] = 1.5
    cases["border_peaks"] = border
    return cases


def calibrate_yolo_heads(torch, yolo, spec, frames_dev, reso):
    """Scale each head conv so its raw output has unit spread on these
    frames.  A random He-initialized YOLOv3 drives its heads to ~1e4, where
    exp(tw) overflows and every box is infinite; trained weights do not."""
    from betapose_tpu_torch.ops.image import resize_bilinear_matmul
    outs = []
    hooks = [yolo.layers[i - 1].register_forward_hook(
        lambda mod, inp, out: outs.append(out.float().std().item()))
        for i in spec.yolo_idxs]
    with torch.inference_mode():
        x = resize_bilinear_matmul(frames_dev.float() / 255.0, reso, reso)
        yolo(x.to(next(yolo.parameters()).dtype))
    for h in hooks:
        h.remove()
    with torch.no_grad():
        for i, s in zip(spec.yolo_idxs, outs):
            conv = yolo.layers[i - 1].conv
            conv.weight.mul_(1.0 / s)
            conv.bias.mul_(1.0 / s)


def build_models(torch, reso, n_kp, arch, frames, device):
    from betapose_tpu_torch.models import kpd as kpd_mod
    from betapose_tpu_torch.models import yolov3 as yolo_mod
    from betapose_tpu_torch.models.darknet_cfg import make_yolov3_cfg
    spec = yolo_mod.build_spec(make_yolov3_cfg(1, reso, reso))
    yolo = yolo_mod.fold_bn(yolo_mod.Darknet(
        spec, reso, torch.Generator().manual_seed(0))).to(device)
    calibrate_yolo_heads(torch, yolo, spec, torch.as_tensor(frames)
                         .to(device), reso)
    kpd = kpd_mod.fold_bn(kpd_mod.FastPose(
        n_kp, arch, torch.Generator().manual_seed(1)))
    return yolo, kpd


def phase_kernels(torch, np, kernels):
    from betapose_tpu_torch.ops.kernels import heatmap_decode as hd
    shape = (8, 50, 80, 64)
    worst = 0.0
    for name, arr in decode_cases(np, shape).items():
        hms = torch.from_numpy(arr).cuda()
        out = hd.decode_peaks(hms)
        ref = hd.decode_peaks_plain(hms)
        torch.cuda.synchronize()
        check(torch.equal(out, ref),
              f"decode_peaks differs from its plain version on {name}")
        worst = max(worst, (out - ref).abs().max().item())
        print(f"decode_peaks == plain on {name} {list(shape)}: bitwise equal")
    kernels["decode_peaks"]["max_abs_err"] = worst


def phase_main_path(torch, np, kernels, card, profile_out):
    from betapose_tpu_torch.core.profiling import RuntimeProfile
    from betapose_tpu_torch.eval.pipeline import PipelineConfig, PosePipeline
    from betapose_tpu_torch.ops.kernels import heatmap_decode as hd

    batch, steps = 8, 6
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (batch, 480, 640, 3), dtype=np.uint8)
    kp3d = rng.standard_normal((50, 3)) * 0.05
    t0 = time.perf_counter()
    yolo, kpd = build_models(torch, 416, 50, "resnet101", frames, "cuda")
    pipe = PosePipeline(yolo, kpd, kp3d, np.asarray(CAM_K), PipelineConfig(),
                        device="cuda")
    print(f"main path: models built in {time.perf_counter() - t0:.1f} s "
          f"(YOLOv3-416 1 class + FastPose SE-ResNet101 50 kp, bf16, "
          f"BN folded)")

    out = pipe(frames)                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    hd.decode_peaks.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        out = pipe(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decode_peaks": hd.decode_peaks.launches}

    for name, n in launches.items():
        kernels[name]["launches"] = n
        check(n == steps, f"{name} launched {n} times in {steps} steps")
    shapes = {"boxes": (batch, 4), "obj_score": (batch,),
              "det_valid": (batch,), "keypoints": (batch, 50, 2),
              "kp_scores": (batch, 50), "proposal_score": (batch,),
              "pose_valid": (batch,), "cam_R": (batch, 3, 3),
              "cam_t": (batch, 3)}
    check(set(out) == set(shapes), f"output keys {sorted(out)}")
    for k, shp in shapes.items():
        check(tuple(out[k].shape) == shp, f"{k} has shape {out[k].shape}")
        check(bool(torch.isfinite(out[k].float()).all()), f"{k} not finite")
    check(bool(out["det_valid"].all()), "no detection at confidence 0.01")
    fps = batch * steps / wall
    print(f"main path: {steps} steps of batch {batch} in {wall:.3f} s, "
          f"{fps:.1f} frames/s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")

    prof = RuntimeProfile()
    for _ in range(3):
        pipe.profiled_call(frames, prof)
    print("main path stages (mean of 3, synchronized): "
          f"dt {prof.mean('dt') * 1e3:.2f} ms | pt {prof.mean('pt') * 1e3:.2f}"
          f" ms | pn {prof.mean('pn') * 1e3:.2f} ms [{card}]")

    with torch.inference_mode():
        det = pipe.det_stage(pipe.yolo, pipe.to_device(frames))
        hm = pipe.pose_stage(pipe.kpd, det["crops"])
    check(tuple(hm.shape) == (batch, 50, 80, 64), f"heatmaps {hm.shape}")
    k_out = hd.decode_peaks(hm)
    p_out = hd.decode_peaks_plain(hm)
    torch.cuda.synchronize()
    check(torch.equal(k_out, p_out),
          "decode_peaks differs from its plain version on the main path's "
          "heatmaps")
    print("decode_peaks == plain on the main path's heatmaps: bitwise equal")
    rec = kernels["decode_peaks"]
    rec["max_abs_err"] = max(rec["max_abs_err"],
                             (k_out - p_out).abs().max().item())
    rec["ms"], k_eager = time_ms(torch, lambda: hd.decode_peaks(hm))
    rec["plain_ms"], p_eager = time_ms(
        torch, lambda: hd.decode_peaks_plain(hm))
    n_bytes = hm.numel() * 4 + k_out.numel() * 4
    rec["bound_ms"] = max(n_bytes / HBM_BYTES_PER_S,
                          hm.numel() / F32_FLOPS) * 1e3
    rec["bound_by"] = ("bytes" if n_bytes / HBM_BYTES_PER_S
                       >= hm.numel() / F32_FLOPS else "operations")
    print(f"decode_peaks {list(hm.shape)}: device time kernel "
          f"{rec['ms'] * 1e3:.2f} us, plain {rec['plain_ms'] * 1e3:.2f} us; "
          f"eager per call kernel {k_eager * 1e3:.2f} us, plain "
          f"{p_eager * 1e3:.2f} us; bound {rec['bound_ms'] * 1e3:.2f} us "
          f"({rec['bound_by']}) [{card}]")

    if profile_out:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            for _ in range(2):
                pipe(frames)
            torch.cuda.synchronize()
        avgs = p.key_averages()
        device_us = sum(e.self_device_time_total for e in avgs
                        if e.device_type == torch.autograd.DeviceType.CUDA)
        table = avgs.table(sort_by="cuda_time_total", row_limit=40)
        with open(profile_out, "w") as f:
            f.write(f"{card}\n2 main-path steps, batch {batch}\n{table}\n")
        step_ms = wall / steps * 1e3
        print(f"profile of 2 steps written to {profile_out}: device busy "
              f"{device_us / 2e3:.2f} ms per step against {step_ms:.2f} ms "
              f"per unprofiled step ({100 * device_us / 2e3 / step_ms:.0f}%"
              f" busy) [{card}]")


def phase_reference(torch, np):
    """float32 on the card vs the CPU, and PnP on planted poses."""
    from betapose_tpu_torch.eval.pipeline import PipelineConfig, PosePipeline
    from betapose_tpu_torch.ops import pnp as pnp_ops
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)
    kp3d = rng.standard_normal((50, 3)) * 0.05
    cfg = PipelineConfig(reso=64, inp_h=64, inp_w=32, out_h=16, out_w=8,
                         compute_dtype="float32")
    yolo, kpd = build_models(torch, 64, 50, "resnet50", frames, "cpu")
    cpu = PosePipeline(yolo, kpd, kp3d, np.asarray(CAM_K), cfg, device="cpu")
    import copy
    gpu = PosePipeline(copy.deepcopy(yolo), copy.deepcopy(kpd), kp3d,
                       np.asarray(CAM_K), cfg, device="cuda")
    with torch.inference_mode():
        dets = [p.det_stage(p.yolo, p.to_device(frames)) for p in (cpu, gpu)]
        hms = [p.pose_stage(p.kpd, d["crops"]) for p, d in zip((cpu, gpu),
                                                               dets)]
        check(torch.equal(dets[0]["det_valid"], dets[1]["det_valid"].cpu()),
              "det_valid differs between the card and the CPU")
        box_err = (dets[0]["boxes"] - dets[1]["boxes"].cpu()).abs().max()
        check(box_err < 1e-2, f"boxes differ by {box_err:.3g} px")
        hm_err = ((hms[0] - hms[1].cpu()).abs().max()
                  / hms[0].abs().max())
        check(hm_err < 1e-3, f"heatmaps differ by {hm_err:.3g} (relative)")
        # the CPU's heatmaps through both post stages: decode exact
        hm = hms[0]
        outs = [cpu.post_stage(hm, dets[0], cpu.kp3d, cpu.cam_K),
                gpu.post_stage(hm.cuda(), {k: v.cuda().clone() for k, v in
                                           dets[0].items()},
                               gpu.kp3d, gpu.cam_K)]
        kp_err = (outs[0]["keypoints"] - outs[1]["keypoints"].cpu()).abs()
        check(kp_err.max() < 1e-3, f"keypoints differ by {kp_err.max()}")
        check(torch.equal(outs[0]["kp_scores"], outs[1]["kp_scores"].cpu()),
              "keypoint scores differ")
    print(f"reference check, float32 card vs CPU at reso 64: boxes within "
          f"{box_err:.2e} px, heatmaps within {hm_err:.2e} relative, "
          f"keypoints within {kp_err.max():.2e} px")

    # best box: exact objectness ties go to the first row on the card too
    from betapose_tpu_torch.ops.boxes import best_box
    pred = torch.rand((4, 300, 6), generator=torch.Generator().manual_seed(2))
    pred[:, 40, 4] = pred[:, 170, 4] = pred[:, 299, 4] = 2.0
    sel = [best_box(pred.to(dev), 0.01)["boxes"].cpu() for dev in
           ("cpu", "cuda")]
    check(torch.equal(sel[0], sel[1]), "best_box differs on the card")
    check(torch.equal(sel[1][:, :2], pred[:, 40, :2] - pred[:, 40, 2:4] / 2),
          "best_box did not take the first of tied rows on the card")
    print("reference check, best_box ties on the card: first row taken")

    # PnP on planted poses (tests/test_pnp.py problems), batch of 8
    K = np.asarray(CAM_K)
    p3s, p2s, truths = [], [], []
    for s in range(8):
        r = np.random.default_rng(100 + s)
        p3 = r.standard_normal((50, 3)) * 0.05
        q, _ = np.linalg.qr(r.standard_normal((3, 3)))
        q[:, 0] *= np.sign(np.linalg.det(q))
        t = np.array([r.uniform(-0.1, 0.1), r.uniform(-0.1, 0.1),
                      r.uniform(0.6, 1.2)])
        uv = (K @ (p3 @ q.T + t).T).T
        p3s.append(p3)
        p2s.append(uv[:, :2] / uv[:, 2:3])
        truths.append((q, t))
    poses = {}
    for dev in ("cuda", "cpu"):
        f32 = dict(dtype=torch.float32, device=dev)
        R, t = pnp_ops.solve_pnp(torch.tensor(np.stack(p3s), **f32),
                                 torch.tensor(np.stack(p2s), **f32),
                                 torch.tensor(K, **f32), iters=12)
        poses[dev] = (R.cpu().numpy(), t.cpu().numpy())

    def add(p3, a, b):
        return np.mean(np.linalg.norm((p3 @ a[0].T + a[1])
                                      - (p3 @ b[0].T + b[1]), axis=1))

    R, t = poses["cuda"]
    Rc, tc = poses["cpu"]
    to_truth = max(add(p3, (R[i], t[i]), truths[i])
                   for i, p3 in enumerate(p3s))
    to_cpu = max(add(p3, (R[i], t[i]), (Rc[i], tc[i]))
                 for i, p3 in enumerate(p3s))
    check(to_truth < 1e-3, f"PnP on the card: ADD to truth {to_truth:.2e} m")
    check(to_cpu < 1e-4, f"PnP card vs CPU: ADD {to_cpu:.2e} m")
    print(f"reference check, PnP on the card (8 planted noiseless poses): "
          f"ADD to truth at most {to_truth * 1e3:.3f} mm, to the CPU solve "
          f"{to_cpu * 1e3:.4f} mm")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-out", default=None,
                    help="write a torch.profiler table of two steps here")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA device")
    from betapose_tpu_torch.core.device import resolve_device
    from betapose_tpu_torch.ops.kernels import build

    resolve_device("cuda")                  # TF32 off for f32 convs/matmuls
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"built {len(reports)} kernel source(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    for src, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    kernels = {"decode_peaks": {
        "name": "decode_peaks", "route": "cuda",
        "source": "betapose_tpu_torch/csrc/heatmap_decode.cu",
        "replaces": "betapose_tpu/ops/pallas/heatmap_decode.py:77",
        "launches": 0, "max_abs_err": None, "ms": None, "plain_ms": None,
        "bound_ms": None, "bound_by": "bytes", "library_ms": None}}

    phase_kernels(torch, np, kernels)
    phase_main_path(torch, np, kernels, card, args.profile_out)
    phase_reference(torch, np)

    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
