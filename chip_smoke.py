#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`betapose_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile-out FILE]

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. The card (name and power limit from nvidia-smi) and the torch version;
   every CUDA kernel of the package is built from `betapose_tpu_torch/csrc/`
   (one nvcc per source, all started together).
2. Each kernel against its plain PyTorch version on the card, at its
   path's shapes and on edge cases: `decode_peaks` bitwise equal;
   `bottleneck_chain` (bf16) within max|k-p| / max|p| <= 2e-2, the JAX
   package's bf16 bar, with its tile per case, and over one-row frames
   that take every width instance of the kernel.
3. The main path at full width: YOLOv3-416 (1 class) -> FastPose
   SE-ResNet101 (50 keypoints) -> peak decode -> PnP through
   `PosePipeline` at batch 8 of 480x640 frames, bf16 convs, seeded random
   weights with batch norm folded.  One warm-up step, then timed steps with
   the kernels' launch counts set to 0 before and read after; every kernel
   of the path must have launched once per step.  The step's own heatmaps
   go through the kernel and the plain version again, bitwise equal.
4. The multi-candidate path at full width on phase 3's models and frames,
   with the occlusion recipe (capacity 4, NMS 0.4, 2 robust PnP rounds,
   score power 4, 10 keypoints), in both modes: device pose-NMS and host
   pose-NMS.  Each mode: a warm-up step, timed steps with the decode
   kernel's launch count set to 0 before and read after (once per step),
   the capacity-1 step's keys and shapes, all finite, frames/s, peak
   memory and dt/pt/pn.  The modes agree within the bars of
   tests/test_pipeline.py::TestMultiCandidate, and the kernel is bitwise
   equal to its plain version on the step's own [32,50,80,64] heatmaps,
   timed there.
5. The hgPRM path at full width: phase 3's YOLOv3-416 and frames ->
   PyraNet (nFeats 256, nStack 4, 50 keypoints, 320x256 crops, float32
   with TF32 off, seeded weights) -> peak decode -> PnP through
   `PosePipeline(net_type="hgPRM")`.  A warm-up step, timed steps with the
   decode kernel's launch count set to 0 before and read after (once per
   step), the capacity-1 step's keys and shapes, frames/s, peak memory,
   dt/pt/pn, and the kernel bitwise equal to its plain version on the
   step's own [8,50,80,64] heatmaps.
6. Small-input reference checks: the float32 pipeline on the card against
   the same pipeline on the CPU, for capacity 1 and for the multi-candidate
   path in both modes (boxes, det_valid, then the CPU's heatmaps through
   both post stages: keypoints, cam_t), for hgPRM (reso 64, 64x64 crops,
   nFeats 16, nStack 2: det_valid, boxes, heatmaps, keypoints, cam_t), and
   PnP on the card recovering planted poses.
7. KPD training through the CLI's epoch loop
   (`train/train_kpd_main.train_kpd`) on frames made on the card: FastPose
   SE-ResNet101 (50 keypoints, 320x256 crops, batch 40, bf16 conv
   precision, DPG, rotation 30, rmsprop) for 2 warm-up and 10 timed steps
   (step ms from CUDA events, split into augmentation and
   forward+backward+update, images/s, peak memory); the peak-decode and
   bottleneck-chain kernels launched 0 times; loss and acc finite; the BN
   running statistics moved; model_final.npz reloads to bitwise equal
   heatmaps; the loss on one repeated batch falls over 20 steps; one step
   in bf16 against float32 from the same weights (loss within 1e-2);
   hgPRM (nFeats 256, nStack 4) at batch 8 for 3 steps, its running
   statistics unchanged and its snapshot's calibrated; the float32 train
   step (resnet50, 64x32, batch 4, 3 steps, fixed draws) on the card
   against the CPU: loss and acc within 1e-4 relative, parameters within
   1e-3 of the largest update.
8. YOLOv3 training through the CLI's loop
   (`train/train_yolo_main.train_from_data_cfg`) on 128 seeded 480x640
   PNG frames with planted boxes and darknet label files written to a
   temporary directory: YOLOv3-416 (1 class) at batch 64, bf16 conv
   precision, 2 warm-up and 10 timed steps (ms per step on the host
   clock, images/s, the split between the host decode and copy, the
   augmentation and forward+backward+update from CUDA events at the
   loop's marks, the busy share from torch.profiler, peak memory: a
   `{"yolo_train": ...}` line); the peak-decode and bottleneck-chain
   kernels launched 0 times; the final .weights reloads to bitwise equal
   eval heads; one step at each random-resize bucket (224, 384, 416, 544)
   at batch 16 and at 544 with batch 32, with peak memory (a
   `{"yolo_train_buckets": ...}` line); the float32 train step on the card
   against the CPU (two heads, 64x64, batch 3, 3 steps, fixed draws):
   loss within 1e-4 relative, parameters within 1e-3 of the largest
   update, running statistics within 1e-5 of their largest.
9. The accuracy tiers (`tools/selftest`, `tools/sweep`): the fast
   selftest trained on the card in a temporary params_dir (60 rendered
   scenes, 250 YOLO and 1500 KPD iterations, 8 held-out frames) with its
   render time, ms per YOLO and KPD step, the KPD loop's busy share over
   2 profiled steps, peak memory and ADD / 2D / IoU stats (a
   `{"selftest": ...}` line); decode launched once (its one eval call),
   the chain never, and decode bitwise equal to its plain version on that
   eval's [8,12,32,24] heatmaps; the cache reloaded on the card and on
   the CPU (float32, TF32 off): equal n_detected, mean and median ADD
   within 0.5 mm or 1%, 2D error within 0.5 px or 1%.  Then the sweep cut
   to cube and prism, 100 scenes, 300 YOLO and 100 KPD iterations, no
   fine-tune, 8 eval frames: the 15-class YOLOv3-416, target_class
   routing, both objects detected and the prism's poses graded by ADD-S
   (finite), decode once per object's eval and bitwise equal on both
   objects' heatmaps together ([16,26,80,64]).  Then
   occl_multiobj cut to 48 cluttered scenes, 300 YOLO and 10 KPD
   iterations per object and 8 eval frames, through the occlusion CLI
   at capacity 4: both objects' poses graded (finite ADD), decode once
   per object's eval batch and bitwise equal on each object's
   [32,26,80,64] heatmaps.
10. The probe path, the second slice's: `tools/probe_vmem_chain` at batch
   96 over the three bottleneck shapes, with the launch counts set to 0
   before and read after; `bottleneck_chain` must have launched once per
   kernel call the probe made (the probe itself raises when the kernel and
   the cuDNN chain disagree; phase 2 is the check against the plain
   version).  Then the kernel, its plain version and the cuDNN chain are
   timed at each shape, with the kernel's tile, blocks and widths.
11. The s2d stem: the float32 det stage at reso 416 with and without
   `s2d_stem` on the same frames (raw heads within the JAX test's
   statistical bar, equal det_valid, boxes within 1 px), then both stems
   timed in bf16 at batch 8.
12. YOLO's bf16 layers, which round once (float32 sums, bias and leaky,
   the JAX `_conv_layer`'s numerics, through TF32 convs of bf16 values):
   two layers on the card against the same layers on the CPU (at least
   99% of outputs bitwise equal, the rest 1 bf16 ulp apart or within 1e-5
   of the largest output: float32 summation order); the
   bf16 YOLO forward at batch 8 (eager and from a CUDA graph) with the
   earlier layer (an inline copy of its three-rounding epilogue, on a bf16
   copy of the network) and with the current one, in turns; and
   how often the old layer changes det_valid and the best box against the
   new one, and each against the float32 network, on the same 8 frames
   (with random weights the best box is an argmax over near-tied
   objectness scores, so the raw heads' distance from the float32
   network's is printed as well).
13. `tools/profile_pipeline` (capacity 1 and 4), `tools/probe_conv_mfu`
   and `tools/probe_s2d_stage` once each at reduced iterations.

Then a `{"kernels": [...]}` JSON line (per kernel: launches on its path,
and per path where it runs on several, max abs error against the plain
version over every check, its time, the plain version's time, the
memory/compute bound and the library yardstick, in ms, and per shape
where it runs at several), the
card line again, and as the last line `{"ok": true, "device": {...}}`.
--profile-out writes a torch.profiler table of two steps of each of the
capacity-1, multi-candidate and hgPRM paths and of FastPose and YOLOv3
training (device time by kernel).
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor
# FLOP/s, dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

# bottleneck_chain cases (B, H, W, Cin, Cm): the probe's three shapes at
# batch 96, then edge cases: the JAX test shapes, B=1, H=W=1, H=1; Cin and
# Cm not multiples of 64 (the wgmma M side padded, depth zero-filled);
# W=1; frames cut into several row bands, and into column bands too; tiles
# whose position counts are not multiples of 8 (most of these)
CHAIN_PROBE = [(96, 13, 13, 1024, 512), (96, 10, 8, 2048, 512),
               (96, 20, 16, 1024, 256)]
CHAIN_EDGES = [(2, 5, 4, 16, 8), (4, 3, 3, 8, 16), (1, 13, 13, 1024, 512),
               (3, 1, 1, 64, 32), (2, 1, 13, 256, 128), (2, 7, 9, 40, 24),
               (2, 6, 7, 24, 40), (2, 5, 5, 8, 8), (3, 9, 1, 16, 8),
               (1, 30, 30, 512, 512), (2, 40, 90, 64, 32)]
# one-row frames of width 1..80: their products take every width instance
# of the kernel (bottleneck_chain.KERNEL_WIDTHS)
CHAIN_WIDTHS = [(1, 1, w, 8, 8) for w in range(1, 81)]
CHAIN_BAR = 2e-2

CAM_K = [[572.4114, 0.0, 325.2611],
         [0.0, 573.57043, 242.04899],
         [0.0, 0.0, 1.0]]

# the occlusion recipe of the JAX package (tools/occl_multiobj.py)
OCCLUSION_RECIPE = dict(det_capacity=4, nms_thresh=0.4, confidence=0.01,
                        pnp_robust_rounds=2, pnp_score_power=4.0,
                        left_keypoints=10)
# device pose-NMS against host pose-NMS: the bars of
# tests/test_pipeline.py::TestMultiCandidate (atol; rtol 1e-3)
MODE_BARS = {"keypoints": 1e-2, "kp_scores": 1e-4, "proposal_score": 1e-3,
             "boxes": 1e-2, "obj_score": 1e-4}


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
    from betapose_tpu_torch.core.profiling import chain_ms
    return (chain_ms(graph.replay, "cuda", k=1, rounds=rounds, warmup=0)
            / reps, chain_ms(fn, "cuda", k=reps, rounds=rounds, warmup=0))


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


def calibrate_yolo_heads(torch, yolo, frames_dev, reso):
    """Scale each head conv so its raw output has unit spread on these
    frames.  A random He-initialized YOLOv3 drives its heads to ~1e4, where
    exp(tw) overflows and every box is infinite; trained weights do not."""
    from betapose_tpu_torch.ops.image import resize_bilinear_matmul
    from betapose_tpu_torch.tools.profile_pipeline import calibrate_heads
    with torch.inference_mode():
        x = resize_bilinear_matmul(frames_dev.float() / 255.0, reso, reso)
    calibrate_heads(yolo, x.to(next(yolo.parameters()).dtype))


def build_models(torch, reso, n_kp, arch, frames, device):
    from betapose_tpu_torch.models import kpd as kpd_mod
    from betapose_tpu_torch.models import yolov3 as yolo_mod
    from betapose_tpu_torch.models.darknet_cfg import make_yolov3_cfg
    spec = yolo_mod.build_spec(make_yolov3_cfg(1, reso, reso))
    yolo = yolo_mod.fold_bn(yolo_mod.Darknet(
        spec, reso, torch.Generator().manual_seed(0))).to(device)
    calibrate_yolo_heads(torch, yolo, torch.as_tensor(frames).to(device),
                         reso)
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


def phase_chain_kernel(torch, kernels):
    """The kernel against its plain version on the probe's inputs (x * 0.1,
    He-scaled weights: the chain's term is as large as the residual), at
    the probe's shapes, the edge cases and over every width instance."""
    from betapose_tpu_torch.ops.kernels import bottleneck_chain as bc
    from betapose_tpu_torch.tools.probe_vmem_chain import chain_inputs

    def compare(shape):
        args = chain_inputs(*shape, "cuda")
        out = bc.bottleneck_chain(*args)
        torch.cuda.synchronize()
        ref = bc.bottleneck_chain_plain(*args)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        ratio = (diff.max() / ref.float().abs().max()).item()
        check(ratio <= CHAIN_BAR, f"bottleneck_chain differs from its plain "
              f"version at {shape}: {ratio:.3g} > {CHAIN_BAR}")
        return diff, ratio

    worst = 0.0
    for shape in CHAIN_PROBE + CHAIN_EDGES:
        diff, ratio = compare(shape)
        worst = max(worst, diff.max().item())
        plan = bc.kernel_plan(*shape)
        print(f"bottleneck_chain vs plain at {list(shape)}: max|k-p|/max|p| "
              f"{ratio:.3e}, {100 * (diff > 0).float().mean().item():.3f}% "
              f"of elements differ (tile {plan['tile']}, {plan['blocks']} "
              f"blocks, widths {plan['widths']})")
    widths, ratios = set(), []
    for shape in CHAIN_WIDTHS:
        diff, ratio = compare(shape)
        worst = max(worst, diff.max().item())
        ratios.append(ratio)
        widths.update(bc.kernel_plan(*shape)["widths"])
    check(widths == set(bc.KERNEL_WIDTHS), f"the width sweep took widths "
          f"{sorted(widths)}, not every instance {bc.KERNEL_WIDTHS}")
    print(f"bottleneck_chain vs plain on {len(CHAIN_WIDTHS)} one-row frames "
          f"(W=1..{len(CHAIN_WIDTHS)}), every width instance "
          f"{bc.KERNEL_WIDTHS[0]}..{bc.KERNEL_WIDTHS[-1]} taken: max|k-p|/"
          f"max|p| at most {max(ratios):.3e}")
    kernels["bottleneck_chain"]["max_abs_err"] = worst


def check_step_outputs(torch, out, batch, path):
    """The step's keys and shapes (the capacity-1 step's, whatever the
    path), all finite, and a detection in every frame."""
    shapes = {"boxes": (batch, 4), "obj_score": (batch,),
              "det_valid": (batch,), "keypoints": (batch, 50, 2),
              "kp_scores": (batch, 50), "proposal_score": (batch,),
              "pose_valid": (batch,), "cam_R": (batch, 3, 3),
              "cam_t": (batch, 3)}
    check(set(out) == set(shapes), f"{path}: output keys {sorted(out)}")
    for k, shp in shapes.items():
        check(tuple(out[k].shape) == shp,
              f"{path}: {k} has shape {out[k].shape}")
        check(bool(torch.isfinite(out[k].float()).all()),
              f"{path}: {k} not finite")
    check(bool(out["det_valid"].all()),
          f"{path}: no detection at confidence 0.01")


def hold_decode(torch, hm, rec, path, card):
    """The decode kernel on a path's own heatmaps: bitwise equal to its
    plain version, then both timed at that shape beside the bytes bound
    (each map read once, [n,K,4] written once).  Appends the shape's entry
    to rec["per_shape"] and returns it.  The times are device times of
    calls whose input stays in L2, as a path's freshly written heatmaps
    do, and of calls whose input is cold in L2 (what the bytes bound
    assumes)."""
    from betapose_tpu_torch.ops.kernels import heatmap_decode as hd
    k_out = hd.decode_peaks(hm)
    p_out = hd.decode_peaks_plain(hm)
    torch.cuda.synchronize()
    check(torch.equal(k_out, p_out), f"decode_peaks differs from its plain "
          f"version on the {path} path's heatmaps {list(hm.shape)}")
    print(f"decode_peaks == plain on the {path} path's heatmaps "
          f"{list(hm.shape)}: bitwise equal")
    rec["max_abs_err"] = max(rec["max_abs_err"],
                             (k_out - p_out).abs().max().item())
    ms, k_eager = time_ms(torch, lambda: hd.decode_peaks(hm))
    plain_ms, p_eager = time_ms(torch, lambda: hd.decode_peaks_plain(hm))
    # cold: the calls take copies of the maps in turn, together 128 MiB or
    # more, so each call reads its input from HBM, not from the 50 MB L2
    copies = itertools.cycle([hm.clone() for _ in range(
        max(2, -(-2**27 // (hm.numel() * 4))))])
    cold_ms, _ = time_ms(torch, lambda: hd.decode_peaks(next(copies)))
    n_bytes = hm.numel() * 4 + k_out.numel() * 4
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, hm.numel() / F32_FLOPS
    entry = {"path": path, "shape": "x".join(map(str, hm.shape)), "ms": ms,
             "ms_l2_cold": cold_ms, "plain_ms": plain_ms,
             "bound_ms": max(t_bytes, t_ops) * 1e3,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    rec.setdefault("per_shape", []).append(entry)
    print(f"decode_peaks {list(hm.shape)} ({path}): device time kernel "
          f"{ms * 1e3:.2f} us (input cold in L2: {cold_ms * 1e3:.2f} us), "
          f"plain {plain_ms * 1e3:.2f} us; eager per "
          f"call kernel {k_eager * 1e3:.2f} us, plain {p_eager * 1e3:.2f} "
          f"us; bound {entry['bound_ms'] * 1e3:.2f} us ({entry['bound_by']},"
          f" {n_bytes / 1e6:.1f} MB) [{card}]")
    return entry


def device_busy_us(torch, avgs):
    """Device time in a profile's key_averages, in us.  Device-side user
    annotations (torch.optim's "Optimizer.step" range) span kernels
    already counted: they are left out."""
    return sum(e.self_device_time_total for e in avgs
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))


def profile_steps(torch, run, batch, step_ms, path, profile_out, mode,
                  card):
    """torch.profiler over 2 calls of `run` (one step each): the device
    time by kernel into `profile_out` (opened with `mode`; None writes no
    table), and the device's busy share against the unprofiled step time,
    which it returns."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(2):
            run()
        torch.cuda.synchronize()
    avgs = p.key_averages()
    device_us = device_busy_us(torch, avgs)
    if profile_out:
        table = avgs.table(sort_by="cuda_time_total", row_limit=40)
        with open(profile_out, mode) as f:
            f.write(f"{card}\n2 {path} steps, batch {batch}\n{table}\n")
    print(f"profile of 2 {path} steps (table: {profile_out}): device busy "
          f"{device_us / 2e3:.2f} ms per step against {step_ms:.2f} ms "
          f"per unprofiled step ({100 * device_us / 2e3 / step_ms:.0f}%"
          f" busy) [{card}]")
    return device_us / 2e3 / step_ms


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
        kernels[name]["launches_per_path"] = {"capacity_1": n}
        check(n == steps, f"{name} launched {n} times in {steps} steps")
    check_step_outputs(torch, out, batch, "main path")
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
    rec = kernels["decode_peaks"]
    entry = hold_decode(torch, hm, rec, "capacity_1", card)
    rec.update({k: entry[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by")})
    rec["shape"] = entry["shape"]

    if profile_out:
        profile_steps(torch, lambda: pipe(frames), len(frames),
                      wall / steps * 1e3, "main-path",
                      profile_out, "w", card)
    return pipe, frames



def compare_modes(np, a, b, what):
    """Max differences between two steps' numpy outputs; fails outside
    MODE_BARS (and cam_t outside rtol 1e-2 where the pose is valid)."""
    check(np.array_equal(a["pose_valid"], b["pose_valid"])
          and np.array_equal(a["det_valid"], b["det_valid"]),
          f"{what}: pose_valid or det_valid differ")
    diffs = {}
    for k, atol in MODE_BARS.items():
        check(np.allclose(a[k], b[k], rtol=1e-3, atol=atol),
              f"{what}: {k} differ by {np.abs(a[k] - b[k]).max():.3g}")
        diffs[k] = float(np.abs(a[k] - b[k]).max())
    diffs["proposal_score_rel"] = float(
        (np.abs(a["proposal_score"] - b["proposal_score"])
         / np.maximum(np.abs(b["proposal_score"]), 1e-6)).max())
    v = a["pose_valid"]
    rel = (np.abs(a["cam_t"][v] - b["cam_t"][v])
           / np.maximum(np.abs(b["cam_t"][v]), 1e-3))
    diffs["cam_t_rel"] = float(rel.max()) if v.any() else 0.0
    check(diffs["cam_t_rel"] <= 1e-2,
          f"{what}: cam_t differ by {diffs['cam_t_rel']:.3g} (relative)")
    return diffs, int(v.sum())


def phase_multi_path(torch, np, kernels, pipe, frames, card, profile_out):
    """The multi-candidate path at full width on the main path's models and
    frames, with the occlusion recipe, in both modes: device pose-NMS and
    host pose-NMS.  Each mode: a warm-up step, then timed steps with the
    decode kernel's launch count set to 0 before and read after (once per
    step); the outputs' keys and shapes; dt/pt/pn.  Then the two modes
    against each other, and the kernel on the step's own [B*N,...]
    heatmaps."""
    import dataclasses
    from betapose_tpu_torch.core.profiling import RuntimeProfile
    from betapose_tpu_torch.eval.pipeline import PosePipeline, to_numpy
    from betapose_tpu_torch.ops.kernels import heatmap_decode as hd

    batch, steps = len(frames), 6
    cap = OCCLUSION_RECIPE["det_capacity"]
    kp3d = pipe.kp3d.cpu().numpy()
    rec = kernels["decode_peaks"]
    outs = {}
    for path, host in (("multi_device", False), ("multi_host", True)):
        cfg = dataclasses.replace(pipe.cfg, host_pose_nms=host,
                                  **OCCLUSION_RECIPE)
        mpipe = PosePipeline(pipe.yolo, pipe.kpd, kp3d, np.asarray(CAM_K),
                             cfg, device="cuda")
        out = mpipe(frames)                              # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hd.decode_peaks.launches = 0
        t0 = time.perf_counter()
        for _ in range(steps):
            out = mpipe(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = hd.decode_peaks.launches
        rec["launches_per_path"][path] = n
        check(n == steps, f"decode_peaks launched {n} times in {steps} "
              f"steps of the {path} path")
        check_step_outputs(torch, out, batch, path)
        peak = torch.cuda.max_memory_allocated() / 2**30
        prof = RuntimeProfile()
        for _ in range(3):
            mpipe.profiled_call(frames, prof)
        print(f"{path} path (capacity {cap}, occlusion recipe): {steps} "
              f"steps of batch {batch} in {wall:.3f} s, "
              f"{batch * steps / wall:.1f} frames/s, peak device memory "
              f"{peak:.2f} GiB; decode_peaks launched {n} times; stages "
              f"(mean of 3, synchronized) dt {prof.mean('dt') * 1e3:.2f} ms "
              f"| pt {prof.mean('pt') * 1e3:.2f} ms | pn "
              f"{prof.mean('pn') * 1e3:.2f} ms [{card}]")
        outs[path] = to_numpy(out)
        if profile_out:
            profile_steps(torch, lambda: mpipe(frames), len(frames),
                          wall / steps * 1e3, path,
                          profile_out, "a", card)

    diffs, n_valid = compare_modes(np, outs["multi_host"],
                                   outs["multi_device"], "multi path modes")
    print(f"multi path, device vs host pose-NMS on the same {batch} frames: "
          f"det_valid and pose_valid equal ({n_valid} valid poses), max "
          + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items()))

    with torch.inference_mode():
        det = mpipe.det_stage(mpipe.yolo, mpipe.to_device(frames))
        hm = mpipe.pose_stage(mpipe.kpd, det["crops"])
    check(tuple(hm.shape) == (batch * cap, 50, 80, 64),
          f"multi path heatmaps {hm.shape}")
    hold_decode(torch, hm, rec, "multi", card)


def phase_hgprm_path(torch, np, kernels, pipe, frames, card, profile_out):
    """The hgPRM path at full width: the main path's YOLO and frames ->
    PyraNet at the opt.py widths (nFeats 256, nStack 4, 50 keypoints),
    float32 with TF32 off, seeded weights -> decode -> PnP."""
    import dataclasses
    from betapose_tpu_torch.core.profiling import RuntimeProfile
    from betapose_tpu_torch.eval.pipeline import PosePipeline
    from betapose_tpu_torch.models import hgprm
    from betapose_tpu_torch.ops.kernels import heatmap_decode as hd

    batch, steps = len(frames), 6
    t0 = time.perf_counter()
    net = hgprm.PyraNet(50, n_feats=256, n_stack=4, n_residual=1,
                        base_width=9, cardinality=5,
                        generator=torch.Generator().manual_seed(2))
    hpipe = PosePipeline(pipe.yolo, net, pipe.kp3d.cpu().numpy(),
                         np.asarray(CAM_K),
                         dataclasses.replace(pipe.cfg, net_type="hgPRM"),
                         device="cuda")
    check(next(hpipe.kpd.parameters()).dtype == torch.float32
          and not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32,
          "hgPRM must run float32 with TF32 off")
    print(f"hgPRM path: PyraNet built in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in net.parameters()) / 1e6:.2f} M "
          f"parameters, nFeats 256, nStack 4, float32, BN not folded)")
    out = hpipe(frames)                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hd.decode_peaks.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        out = hpipe(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = hd.decode_peaks.launches
    rec = kernels["decode_peaks"]
    rec["launches_per_path"]["hgPRM"] = n
    check(n == steps, f"decode_peaks launched {n} times in {steps} steps "
          f"of the hgPRM path")
    check_step_outputs(torch, out, batch, "hgPRM path")
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = RuntimeProfile()
    for _ in range(3):
        hpipe.profiled_call(frames, prof)
    print(f"hgPRM path: {steps} steps of batch {batch} in {wall:.3f} s, "
          f"{batch * steps / wall:.1f} frames/s, peak device memory "
          f"{peak:.2f} GiB; decode_peaks launched {n} times; stages (mean "
          f"of 3, synchronized) dt {prof.mean('dt') * 1e3:.2f} ms | pt "
          f"{prof.mean('pt') * 1e3:.2f} ms | pn {prof.mean('pn') * 1e3:.2f}"
          f" ms [{card}]")
    with torch.inference_mode():
        det = hpipe.det_stage(hpipe.yolo, hpipe.to_device(frames))
        hm = hpipe.pose_stage(hpipe.kpd, det["crops"])
    check(tuple(hm.shape) == (batch, 50, 80, 64) and hm.dtype == torch.float32,
          f"hgPRM heatmaps {hm.shape} {hm.dtype}")
    hold_decode(torch, hm, rec, "hgPRM", card)
    if profile_out:
        profile_steps(torch, lambda: hpipe(frames), len(frames),
                      wall / steps * 1e3, "hgPRM",
                      profile_out, "a", card)


def phase_hgprm_reference(torch, np):
    """hgPRM in float32 at a small size, the card against the CPU: the
    same bars as the capacity-1 check (det_valid equal, then boxes,
    heatmaps, and the CPU's heatmaps through both post stages: keypoints,
    scores, and cam_t)."""
    import copy
    from betapose_tpu_torch.eval.pipeline import PipelineConfig, PosePipeline
    from betapose_tpu_torch.models import hgprm
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)
    kp3d = rng.standard_normal((50, 3)) * 0.05
    cfg = PipelineConfig(reso=64, inp_h=64, inp_w=64, out_h=16, out_w=16,
                         compute_dtype="float32", net_type="hgPRM")
    yolo, _ = build_models(torch, 64, 50, "resnet50", frames, "cpu")
    net = hgprm.PyraNet(50, n_feats=16, n_stack=2,
                        generator=torch.Generator().manual_seed(4))
    cpu = PosePipeline(yolo, net, kp3d, np.asarray(CAM_K), cfg, device="cpu")
    gpu = PosePipeline(copy.deepcopy(yolo), copy.deepcopy(net), kp3d,
                       np.asarray(CAM_K), cfg, device="cuda")
    with torch.inference_mode():
        dets = [p.det_stage(p.yolo, p.to_device(frames)) for p in (cpu, gpu)]
        check(torch.equal(dets[0]["det_valid"], dets[1]["det_valid"].cpu()),
              "hgPRM: det_valid differs between the card and the CPU")
        box_err = (dets[0]["boxes"] - dets[1]["boxes"].cpu()).abs().max()
        check(box_err < 1e-2, f"hgPRM: boxes differ by {box_err:.3g} px")
        # the same crops into both networks, so the heatmaps compare the
        # networks alone
        crops = dets[0]["crops"]
        hms = [cpu.pose_stage(cpu.kpd, crops),
               gpu.pose_stage(gpu.kpd, crops.cuda())]
        hm_err = ((hms[0] - hms[1].cpu()).abs().max() / hms[0].abs().max())
        check(hm_err < 1e-3, f"hgPRM: heatmaps differ by {hm_err:.3g} "
              f"(relative)")
        outs = [cpu.post_stage(hms[0], dets[0], cpu.kp3d, cpu.cam_K),
                gpu.post_stage(hms[0].cuda(), {k: v.cuda().clone() for k, v
                                               in dets[0].items()},
                               gpu.kp3d, gpu.cam_K)]
        kp_err = (outs[0]["keypoints"] - outs[1]["keypoints"].cpu()).abs()
        check(kp_err.max() < 1e-3, f"hgPRM: keypoints differ by "
              f"{kp_err.max()}")
        check(torch.equal(outs[0]["kp_scores"], outs[1]["kp_scores"].cpu()),
              "hgPRM: keypoint scores differ")
        t_cpu, t_gpu = outs[0]["cam_t"], outs[1]["cam_t"].cpu()
        t_err = ((t_gpu - t_cpu).norm(dim=1) / t_cpu.norm(dim=1)).max()
        check(t_err <= 1e-2, f"hgPRM: cam_t differs by {t_err:.3g} "
              f"(relative), card vs CPU")
    print(f"reference check, float32 hgPRM (nFeats 16, nStack 2) card vs "
          f"CPU at reso 64, 64x64 crops: det_valid equal, boxes within "
          f"{box_err:.2e} px, heatmaps within {hm_err:.2e} relative, "
          f"keypoints within {kp_err.max():.2e} px, cam_t within "
          f"{t_err:.2e} relative")


class FrameSet:
    """Seeded frames in memory on the card, served as `.epoch()` batches of
    imgs [B,480,640,3] RGB in [0,1], bndbox [B,4] and part [B,K,2], the
    form `data/annot.KPDTrainDataset` yields; `n_batches` per epoch,
    cycling over the frames."""

    def __init__(self, torch, n_frames, n_kp, batch, n_batches, seed,
                 size=(480, 640)):
        g = torch.Generator(device="cuda").manual_seed(seed)
        h, w = size

        def u(*shape):
            return torch.rand(shape, generator=g, device="cuda")

        self.imgs = u(n_frames, h, w, 3)
        wh = torch.stack([w * (0.25 + 0.3 * u(n_frames)),
                          h * (0.3 + 0.4 * u(n_frames))], 1)
        ul = u(n_frames, 2) * (torch.tensor([w, h], device="cuda") - wh)
        self.boxes = torch.cat([ul, ul + wh], 1)
        self.parts = ul[:, None] + wh[:, None] * (0.15 + 0.7 * u(
            n_frames, n_kp, 2))
        self.batch, self.n_batches = batch, n_batches
        self.rows = torch.arange(batch, device="cuda")

    def epoch(self):
        for i in range(self.n_batches):
            idx = (self.rows + i * self.batch) % len(self.imgs)
            yield {"imgs": self.imgs[idx], "bndbox": self.boxes[idx],
                   "part": self.parts[idx]}


class StepTimer:
    """The train loop's timer hook: a CUDA event at each mark, read after
    the run as per-step (augment, train step) device times in ms."""

    def __init__(self, torch):
        self.torch, self.marks = torch, []

    def __call__(self, name):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    def steps(self):
        self.torch.cuda.synchronize()
        ev = [e for _, e in self.marks]
        return [(ev[i].elapsed_time(ev[i + 1]),
                 ev[i + 1].elapsed_time(ev[i + 2]))
                for i in range(0, len(ev), 3)]


def train_args(extra):
    from betapose_tpu_torch.train import train_kpd_main
    return train_kpd_main.parse_args([
        "--expID", "smoke", "--nEpochs", "1", "--snapshot", "0",
        "--optMethod", "rmsprop", "--LR", "2.5e-4", "--addDPG", "1",
        "--rotate", "30", "--device", "cuda", *extra])


def bn_buffers(torch, model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if "running" in k}


def phase_kpd_train(torch, np, kernels, card, profile_out):
    """KPD training on the card (`train/train_kpd_main.train_kpd`, the
    epoch loop of the CLI) at full width, then its checks: FastPose
    SE-ResNet101 at batch 40 (bf16 convs, DPG, rotation 30, rmsprop),
    hgPRM at batch 8, the card against the CPU in float32, bf16 against
    float32 on the card."""
    import copy
    import shutil
    import tempfile
    from betapose_tpu_torch.core import checkpoint as ckpt
    from betapose_tpu_torch.ops.kernels import bottleneck_chain as bc
    from betapose_tpu_torch.ops.kernels import heatmap_decode as hd
    from betapose_tpu_torch.train import kpd_train
    from betapose_tpu_torch.train import train_kpd_main as tkm
    from betapose_tpu_torch.train.augment import AugmentConfig, augment_batch

    root = tempfile.mkdtemp(prefix="kpd_train_smoke_")
    try:
        warm, timed, batch = 2, 10, 40
        args = train_args(["--netType", "resnet101", "--nClasses", "50",
                           "--trainBatch", str(batch),
                           "--exp_root", root, "--tb_root", root])
        check(args.trainPrecision is None
              and kpd_train.DEFAULT_TRAIN_PRECISION == "bfloat16",
              "the default train precision is bfloat16")
        net = tkm.build_network(args)
        before = bn_buffers(torch, net.model)
        frames = FrameSet(torch, 80, 50, batch, warm + timed, seed=5)
        timer = StepTimer(torch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hd.decode_peaks.launches = 0
        bc.bottleneck_chain.launches = 0
        t0 = time.perf_counter()
        res = tkm.train_kpd(args, frames, None, net, timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for name, fn in (("decode_peaks", hd.decode_peaks),
                         ("bottleneck_chain", bc.bottleneck_chain)):
            kernels[name].setdefault("launches_per_path", {})[
                "kpd_train"] = fn.launches
            check(fn.launches == 0, f"the training path launched {name}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        hist = np.asarray(res.history)
        check(len(hist) == warm + timed and np.isfinite(hist).all(),
              f"FastPose train: loss/acc {hist.tolist()}")
        steps = timer.steps()[warm:]
        aug = np.asarray([a for a, _ in steps])
        fbu = np.asarray([b for _, b in steps])
        step_ms = float(np.median(aug + fbu))
        print(f"kpd train FastPose SE-ResNet101, 50 kp, 320x256 -> 80x64, "
              f"batch {batch}, bf16 convs, DPG, rotate 30, rmsprop: "
              f"{timed} timed steps (after {warm}) median {step_ms:.2f} ms "
              f"per step, {batch * 1e3 / step_ms:.1f} images/s; augment "
              f"{np.median(aug):.2f} ms, forward+backward+update "
              f"{np.median(fbu):.2f} ms (CUDA events); {len(hist)} steps "
              f"in {wall:.2f} s with the model build and model_final.npz; "
              f"peak device memory {peak:.2f} GiB; loss "
              f"{hist[0, 0]:.4g} -> {hist[-1, 0]:.4g} [{card}]")
        after = bn_buffers(torch, res.model)
        moved = max((after[k].cpu() - v.cpu()).abs().max().item()
                    for k, v in before.items())
        check(moved > 1e-3, "FastPose BN running statistics did not move")
        # model_final.npz back through the port's loader: bitwise
        loaded = ckpt.load_kpd_checkpoint(
            f"{res.exp_dir}/model_final.npz", 50, "resnet101").cuda().eval()
        x = frames.imgs[:8, :320, :256] - 0.45
        with torch.no_grad():
            ref = res.model.eval()(x)
            got = loaded(x)
        check(torch.equal(ref, got), "model_final.npz heatmaps differ from "
              "the trained module's")
        print(f"kpd train FastPose: BN running stats moved by up to "
              f"{moved:.3g}; model_final.npz reloads to bitwise equal "
              f"heatmaps [8,50,80,64]")

        # one repeated batch: the loss falls over 20 steps; then bf16
        # against float32 from the same weights on the same batch
        model = res.model
        opt = kpd_train.make_optimizer(model.parameters(), "rmsprop")
        step = kpd_train.make_train_step(model, opt, 80, "bfloat16")
        cfg = AugmentConfig(add_dpg=True, rotate=30.0)
        gen = torch.Generator(device="cuda").manual_seed(9)
        host = next(frames.epoch())
        fixed = augment_batch(host["imgs"], host["bndbox"], host["part"],
                              cfg, gen)
        w0 = copy.deepcopy(model.state_dict())
        losses = [step(fixed)["loss"].item() for _ in range(20)]
        check(np.isfinite(losses).all() and losses[-1] < losses[0],
              f"loss on one repeated batch: {losses}")
        # the optimizer update alone, on the last step's gradients: the
        # host's time to issue it, and the device's to run it
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        for _ in range(5):
            opt.step()
        e1.record()
        host_ms = (time.perf_counter() - t0) * 1e3 / 5
        torch.cuda.synchronize()
        print(f"kpd train FastPose: rmsprop update of "
              f"{sum(1 for _ in model.parameters())} tensors "
              f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
              f"parameters): {host_ms:.2f} ms of host time to issue, "
              f"{e0.elapsed_time(e1) / 5:.2f} ms on the device [{card}]")
        rel = {}
        for mode in ("bfloat16", "float32"):
            model.load_state_dict(w0)
            opt = kpd_train.make_optimizer(model.parameters(), "rmsprop")
            rel[mode] = kpd_train.make_train_step(
                model, opt, 80, mode)(fixed)["loss"].item()
        d = abs(rel["bfloat16"] - rel["float32"]) / abs(rel["float32"])
        check(d < 1e-2, f"bf16 loss {rel['bfloat16']} vs float32 "
              f"{rel['float32']}")
        check(not torch.backends.cudnn.allow_tf32,
              "the train step left TF32 on")
        print(f"kpd train FastPose: loss on one repeated batch "
              f"{losses[0]:.4g} -> {losses[-1]:.4g} over 20 steps; one step "
              f"from the same weights, bf16 loss {rel['bfloat16']:.6g} vs "
              f"float32 {rel['float32']:.6g} ({d:.2e} relative)")
        if profile_out:
            def one():
                b = augment_batch(host["imgs"], host["bndbox"],
                                  host["part"], cfg, gen)
                float(step(b)["loss"])
            profile_steps(torch, one, batch, step_ms, "kpd-train",
                          profile_out, "a", card)
        del res, model, opt, step, loaded, fixed, w0
        torch.cuda.empty_cache()

        phase_hgprm_train(torch, np, tkm, ckpt, root, card)
        phase_train_reference(torch, np, kpd_train)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_hgprm_train(torch, np, tkm, ckpt, root, card):
    """hgPRM (nFeats 256, nStack 4, 320x256 crops) for 3 steps at batch 8
    through the loop, with a snapshot: PyraNet trains without rolling its
    batch-norm statistics, so the snapshot must hold calibrated ones."""
    batch, n = 8, 3
    args = train_args(["--netType", "hgPRM", "--nClasses", "50",
                       "--nFeats", "256", "--nStack", "4",
                       "--trainBatch", str(batch), "--snapshot", "1",
                       "--expID", "hg", "--exp_root", root,
                       "--tb_root", root])
    net = tkm.build_network(args)
    before = bn_buffers(torch, net.model)
    frames = FrameSet(torch, 16, 50, batch, n, seed=6)
    timer = StepTimer(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = tkm.train_kpd(args, frames, None, net, timer)
    peak = torch.cuda.max_memory_allocated() / 2**30
    hist = np.asarray(res.history)
    check(len(hist) == n and np.isfinite(hist).all(),
          f"hgPRM train: loss/acc {hist.tolist()}")
    after = bn_buffers(torch, res.model)
    check(all(torch.equal(after[k].cpu(), v.cpu())
              for k, v in before.items()),
          "hgPRM training rolled its BN running statistics")
    snap = ckpt.load_pytree_npz(f"{res.exp_dir}/model_0.npz")
    calibrated = float(np.abs(snap["bn1"]["var"] - 1.0).max())
    check(calibrated > 1e-3, "the hgPRM snapshot's BN statistics are "
          "not calibrated")
    ms = [a + b for a, b in timer.steps()]
    print(f"kpd train hgPRM nFeats 256, nStack 4, 320x256, batch {batch}, "
          f"bf16 convs: step ms {', '.join(f'{m:.1f}' for m in ms)} (the "
          f"first with warm-up); loss {hist[0, 0]:.4g} -> {hist[-1, 0]:.4g};"
          f" running stats unchanged, the snapshot's calibrated (bn1 var "
          f"off 1 by up to {calibrated:.3g}); peak device memory "
          f"{peak:.2f} GiB [{card}]")


def phase_train_reference(torch, np, kpd_train):
    """The train step on the card against the CPU, float32 with TF32 off:
    FastPose resnet50, 4 keypoints, 64x32 crops, batch 4, 3 steps, rmsprop
    with momentum 0.9 and weight decay 1e-4, the same fixed draws.  The
    batch norms' scales and biases are drawn from U(0.1, 0.3) and
    U(0.5, 1.5), as in tests/test_torch_kpd_train.py, where few ReLU
    inputs sit near zero and two float32 runs can agree to 1e-3 of an
    update."""
    import copy
    from betapose_tpu_torch.models import kpd as kpd_mod
    from betapose_tpu_torch.train import augment

    g = torch.Generator().manual_seed(3)
    model = kpd_mod.FastPose(4, "resnet50", g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.1, 0.3, generator=g)
                m.bias.uniform_(0.5, 1.5, generator=g)
    w0 = {k: v.clone() for k, v in model.named_parameters()}
    cfg = augment.AugmentConfig(inp_h=64, inp_w=32, out_h=16, out_w=8,
                                add_dpg=True)
    rng = np.random.default_rng(4)
    data = [(torch.from_numpy(rng.uniform(0, 1, (4, 96, 128, 3))
                              .astype(np.float32)),
             torch.tensor([[20.0, 15.0, 100.0, 80.0]] * 4),
             torch.from_numpy(rng.uniform(30, 90, (4, 4, 2))
                              .astype(np.float32)),
             augment.draw_random(4, cfg, torch.Generator().manual_seed(s)))
            for s in range(3)]
    hist, params = {}, {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
        opt = kpd_train.make_optimizer(m.parameters(), "rmsprop", 2.5e-4,
                                       0.9, 1e-4)
        step = kpd_train.make_train_step(m, opt, 16, "float32")
        hist[dev] = []
        for imgs, boxes, parts, d in data:
            b = augment.augment_batch(
                imgs.to(dev), boxes.to(dev), parts.to(dev), cfg,
                draws={k: v.to(dev) for k, v in d.items()})
            r = step(b)
            hist[dev].append((r["loss"].item(), r["acc"].item()))
        params[dev] = {k: v.detach().cpu() for k, v in m.named_parameters()}
    h_cpu, h_gpu = np.asarray(hist["cpu"]), np.asarray(hist["cuda"])
    loss_rel = float((np.abs(h_gpu - h_cpu) / np.abs(h_cpu).clip(1e-12))
                     [:, 0].max())
    check(loss_rel <= 1e-4, f"train loss card vs CPU: {hist}")
    check(np.allclose(h_gpu[:, 1], h_cpu[:, 1], rtol=1e-4, atol=0),
          f"train acc card vs CPU: {hist}")
    update = max((params["cpu"][k] - w0[k]).abs().max().item() for k in w0)
    worst = max((params["cuda"][k] - params["cpu"][k]).abs().max().item()
                for k in w0)
    check(worst <= 1e-3 * update, f"params card vs CPU: {worst:.3g} "
          f"against the largest update {update:.3g}")
    print(f"reference check, float32 train step (FastPose resnet50, 4 kp, "
          f"64x32, batch 4, 3 steps, fixed draws) card vs CPU: loss within "
          f"{loss_rel:.2e} relative, acc equal, parameters within "
          f"{worst / update:.2e} of the largest update ({update:.3g})")


# a two-head YOLO for the float32 card-vs-CPU training check: a shortcut,
# a route of one and of two layers, an upsample, the anchors split across
# the heads (the coarse head first, as in YOLOv3's cfg)
YOLO_TINY_CFG = "".join(
    f"[{b}]\n" + "".join(f"{k}={v}\n" for k, v in kv.items()) + "\n"
    for b, kv in [
        ("net", dict(width=64, height=64, channels=3)),
        *[("convolutional", dict(batch_normalize=1, filters=f, size=k,
                                 stride=s, pad=1, activation="leaky"))
          for f, k, s in ((8, 3, 2), (16, 3, 2), (8, 1, 1), (16, 3, 1))],
        ("shortcut", {"from": -3, "activation": "linear"}),
        ("convolutional", dict(batch_normalize=1, filters=32, size=3,
                               stride=2, pad=1, activation="leaky")),
        ("convolutional", dict(size=1, stride=1, pad=1, filters=21,
                               activation="linear")),
        ("yolo", dict(mask="3,4,5", anchors="6,8,10,12,14,10,20,24,30,20,"
                      "40,44", classes=2, num=6, ignore_thresh=0.6,
                      focal_loss=1)),
        ("route", dict(layers=-3)),
        ("convolutional", dict(batch_normalize=1, filters=16, size=1,
                               stride=1, pad=1, activation="leaky")),
        ("upsample", dict(stride=2)),
        ("route", dict(layers="-1,-7")),
        ("convolutional", dict(batch_normalize=1, filters=16, size=3,
                               stride=1, pad=1, activation="leaky")),
        ("convolutional", dict(size=1, stride=1, pad=1, filters=21,
                               activation="linear")),
        ("yolo", dict(mask="0,1,2", anchors="6,8,10,12,14,10,20,24,30,20,"
                      "40,44", classes=2, num=6, ignore_thresh=0.7))])
YOLO_BUCKETS = ((224, 16), (384, 16), (416, 16), (544, 16), (544, 32))


def write_yolo_dataset(np, root, n, seed):
    """n seeded 480x640 PNG frames, each with 1-3 planted boxes (textured
    rectangles on a dim noisy gradient) and its darknet label file, the
    list and the .data file: LineMod's frame size and one class, as
    `tools/yolo_data_prep` writes them.  Returns (.data path, paths)."""
    import concurrent.futures as cf
    import os
    import cv2
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    ramp = np.linspace(0, 60, 640, dtype=np.float32)[None, :, None]

    def make(i):
        r = np.random.default_rng([seed, i])
        img = (r.integers(0, 40, (480, 640, 3)) + ramp).astype(np.uint8)
        lines = []
        for _ in range(r.integers(1, 4)):
            w, h = int(r.integers(40, 240)), int(r.integers(40, 200))
            x0 = int(r.integers(0, 640 - w))
            y0 = int(r.integers(0, 480 - h))
            img[y0:y0 + h, x0:x0 + w] = (r.integers(120, 200, 3)
                                         + r.integers(0, 50, (h, w, 3)))
            lines.append(f"0 {(x0 + w / 2) / 640:f} {(y0 + h / 2) / 480:f} "
                         f"{w / 640:f} {h / 480:f}\n")
        path = os.path.join(img_dir, f"{i:04d}.png")
        cv2.imwrite(path, img)
        with open(path[:-4] + ".txt", "w") as f:
            f.writelines(lines)
        return path

    with cf.ThreadPoolExecutor(8) as pool:
        paths = list(pool.map(make, range(n)))
    lst = os.path.join(root, "all.txt")
    with open(lst, "w") as f:
        f.writelines(p + "\n" for p in paths)
    data = os.path.join(root, "smoke.data")
    with open(data, "w") as f:
        f.write(f"classes = 1\ntrain = {lst}\nvalid = {lst}\n"
                f"backup = {os.path.join(root, 'backup')}\n")
    return data, paths


class MarkTimer:
    """The YOLO loop's timer hook: a CUDA event and the host clock at each
    of its four marks.  `steps()`: per step the device ms from "start" to
    "loaded" (the host decode and the copy, the device idle), to
    "augmented" and to "stepped" (forward, backward and update), and the
    host ms from one "start" to the next (None for the last)."""

    def __init__(self, torch):
        self.torch, self.marks = torch, []

    def __call__(self, name):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((ev, time.perf_counter()))

    def steps(self):
        self.torch.cuda.synchronize()
        m = self.marks
        return [(m[i][0].elapsed_time(m[i + 1][0]),
                 m[i + 1][0].elapsed_time(m[i + 2][0]),
                 m[i + 2][0].elapsed_time(m[i + 3][0]),
                 (m[i + 4][1] - m[i][1]) * 1e3 if i + 4 < len(m) else None)
                for i in range(0, len(m), 4)]


def phase_yolo_train(torch, np, kernels, card, profile_out):
    """YOLOv3 training on the card through the CLI's loop
    (`train/train_yolo_main.train_from_data_cfg`) at full width, then its
    checks: YOLOv3-416 (1 class, 61.5 M parameters) at batch 64, bf16
    conv precision, from 128 seeded PNG frames; one step at each
    random-resize bucket; the snapshot; the card against the CPU in
    float32."""
    import concurrent.futures as cf
    import io
    import os
    import re
    import shutil
    import tempfile
    from betapose_tpu_torch.data.loader import imread_rgb
    from betapose_tpu_torch.models import yolov3 as yolo_mod
    from betapose_tpu_torch.models.darknet_cfg import make_yolov3_cfg
    from betapose_tpu_torch.ops.kernels import bottleneck_chain as bc
    from betapose_tpu_torch.ops.kernels import heatmap_decode as hd
    from betapose_tpu_torch.train import train_yolo_main, yolo_train

    root = tempfile.mkdtemp(prefix="yolo_train_smoke_")
    try:
        t0 = time.perf_counter()
        data, paths = write_yolo_dataset(np, root, 128, seed=7)
        kib = np.mean([os.path.getsize(p) for p in paths]) / 1024
        print(f"yolo train: wrote 128 seeded 480x640 PNG frames with "
              f"planted boxes ({kib:.0f} KiB each on average) in "
              f"{time.perf_counter() - t0:.1f} s [{card}]")
        cfg_path = os.path.join(root, "smoke.cfg")
        with open(cfg_path, "w") as f:
            f.write(make_yolov3_cfg(num_classes=1))      # 416, batch 64
        warm, timed, batch, reso = 2, 10, 64, 416
        timer = MarkTimer(torch)
        log = io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hd.decode_peaks.launches = 0
        bc.bottleneck_chain.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            model = train_yolo_main.train_from_data_cfg(
                data, cfg_path, None, batch=batch, snapshot_every=0,
                max_batches=warm + timed, resize_buckets=1, device="cuda",
                timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sys.stdout.write(log.getvalue())
        for name, fn in (("decode_peaks", hd.decode_peaks),
                         ("bottleneck_chain", bc.bottleneck_chain)):
            kernels[name].setdefault("launches_per_path", {})[
                "yolo_train"] = fn.launches
            check(fn.launches == 0,
                  f"the YOLO training path launched {name}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [float(v) for v in re.findall(
            r"^\d+: (\S+), \S+ avg, reso 416,", log.getvalue(), re.M)]
        check(len(losses) == warm + timed and np.isfinite(losses).all(),
              f"YOLO train losses {losses}")
        steps = timer.steps()[warm:]
        load, aug, fbu = (np.asarray([s[i] for s in steps])
                          for i in range(3))
        step_ms = float(np.median([s[3] for s in steps if s[3]]))
        n_par = sum(p.numel() for p in model.parameters())
        nparams = f"{n_par / 1e6:.1f} M parameters"
        print(f"yolo train YOLOv3-416, 1 class ({nparams}), batch {batch}, "
              f"bf16 convs, crop-jitter + flip + HSV on the card, SGD: "
              f"{timed} timed steps (after {warm}) median {step_ms:.2f} ms "
              f"per step (host clock), {batch * 1e3 / step_ms:.1f} images/s"
              f"; host decode and copy {np.median(load):.2f} ms, augment "
              f"{np.median(aug):.2f} ms, forward+backward+update "
              f"{np.median(fbu):.2f} ms (CUDA events); {warm + timed} steps"
              f" in {wall:.2f} s with the model build and the final "
              f".weights; peak device memory {peak:.2f} GiB; loss "
              f"{losses[0]:.4g} -> {losses[-1]:.4g} [{card}]")

        # the snapshot back through the loader: bitwise equal eval heads
        spec = model.spec
        loaded, header = yolo_mod.load_darknet_weights(
            spec, os.path.join(root, "backup", "smoke_final.weights"), reso)
        loaded = loaded.cuda().eval()
        check(int(header[3]) == (warm + timed) * batch, f"seen {header}")
        tcfg = train_yolo_main._net_cfg_options(spec)
        rng = np.random.default_rng(9)
        gen = torch.Generator(device="cuda").manual_seed(9)
        _, truths = yolo_train.load_darknet_labels(
            os.path.join(root, "all.txt"), tcfg.max_boxes)
        pool = cf.ThreadPoolExecutor(8)

        def host_batch(b):
            idx = rng.integers(0, len(paths), b)
            imgs = np.stack(list(pool.map(lambda i: imread_rgb(paths[i]),
                                          idx)))
            return (torch.from_numpy(imgs).cuda(),
                    torch.from_numpy(truths[idx]).cuda())

        def augmented(b, r):
            imgs, tr = host_batch(b)
            return yolo_train.augment_detection_batch(
                imgs.float() / 255.0, tr, tcfg, r, r, gen)

        x, _ = augmented(8, reso)
        with torch.no_grad():
            ref = model.eval()(x, decode=False)
            got = loaded(x, decode=False)
        check(all(torch.equal(a, b) for a, b in zip(ref, got)),
              "smoke_final.weights heads differ from the trained module's")
        print("yolo train: smoke_final.weights (seen "
              f"{int(header[3])}) reloads to bitwise equal eval heads "
              f"{[tuple(h.shape) for h in ref]} [{card}]")
        del loaded, ref, got

        # the loop's body once more under the profiler: the busy share
        opt = yolo_train.make_optimizer(model, tcfg)
        step = yolo_train.make_train_step(model, opt, reso, reso)

        def one():
            a, t = augmented(batch, reso)
            float(step(a, t)["loss"])
        busy = profile_steps(torch, one, batch, step_ms, "yolo-train",
                             profile_out, "a", card)
        print(json.dumps({"yolo_train": {
            "card": card, "model": "YOLOv3-416, 1 class "
            "(make_yolov3_cfg), " + nparams, "batch": batch, "reso": reso,
            "precision": "bfloat16", "warmup_steps": warm,
            "timed_steps": timed, "ms_per_step": step_ms,
            "images_per_s": batch * 1e3 / step_ms,
            "split_ms": {"host_decode_copy": float(np.median(load)),
                         "augment": float(np.median(aug)),
                         "forward_backward_update": float(np.median(fbu))},
            "busy_share": busy, "peak_gib": peak,
            "loss_first": losses[0], "loss_last": losses[-1]}}))

        # one step at each random-resize bucket (resolution_buckets(416))
        check([r for r, b in YOLO_BUCKETS if b == 16]
              == train_yolo_main.resolution_buckets(416),
              "the buckets of resolution_buckets(416)")
        rows = []
        for r, b in YOLO_BUCKETS:
            step = yolo_train.make_train_step(model, opt, r, r)
            a, t = augmented(b, r)
            float(step(a, t)["loss"])            # the shape's first step
            del a, t
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            a, t = augmented(b, r)
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
            loss = float(step(a, t)["loss"])
            e1.record()
            torch.cuda.synchronize()
            check(np.isfinite(loss), f"bucket {r} loss {loss}")
            rows.append({"reso": r, "batch": b,
                         "ms": e0.elapsed_time(e1),
                         "peak_gib": torch.cuda.max_memory_allocated()
                         / 2**30})
            del a, t
        p16, p32 = (x["peak_gib"] for x in rows if x["reso"] == 544)
        print(json.dumps({"yolo_train_buckets": {
            "card": card, "rows": rows,
            "peak_gib_544_batch64_linear": p32 + (p32 - p16) * 2}}))
        pool.shutdown()
        del model, opt, step
        torch.cuda.empty_cache()
        phase_yolo_train_reference(torch, np, yolo_mod, yolo_train, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_yolo_train_reference(torch, np, yolo_mod, yolo_train, card):
    """The YOLO train step on the card against the CPU, float32 with TF32
    off: the two-head `YOLO_TINY_CFG`, batch 3 of 80x96 frames augmented
    to 64x64 with fixed draws, 3 SGD steps; the bars of
    tests/test_torch_yolo_train.py (loss within 1e-4 relative, parameters
    within 1e-3 of the largest update, running statistics within 1e-5 of
    each one's largest)."""
    import copy
    g = torch.Generator().manual_seed(4)
    model = yolo_mod.Darknet(yolo_mod.build_spec(YOLO_TINY_CFG), 64, g)
    with torch.no_grad():
        for _, m in yolo_mod.conv_layers(model):
            if m.bn is not None:
                m.bn.weight.uniform_(0.5, 1.5, generator=g)
                m.bn.bias.normal_(0.0, 0.3, generator=g)
    cfg = yolo_train.YoloTrainConfig(lr=1e-3, burn_in=2, steps=(100,),
                                     scales=(0.1,))
    rng = np.random.default_rng(4)
    data = []
    for s in range(3):
        tr = np.zeros((3, 4, 5), np.float32)
        tr[:, :2] = np.concatenate([rng.uniform(0.2, 0.8, (3, 2, 2)),
                                    rng.uniform(0.1, 0.5, (3, 2, 2)),
                                    rng.integers(0, 2, (3, 2, 1))], -1)
        data.append((torch.from_numpy(rng.uniform(0, 1, (3, 80, 96, 3))
                                      .astype(np.float32)),
                     torch.from_numpy(tr),
                     yolo_train.draw_random(
                         3, 80, 96, cfg, torch.Generator().manual_seed(s))))
    w0 = yolo_mod.params_to_jax(model)
    hist, params = {}, {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
        opt = yolo_train.make_optimizer(m, cfg)
        step = yolo_train.make_train_step(m, opt, 64, 64, "float32")
        hist[dev] = []
        for imgs, tr, d in data:
            a, t = yolo_train.augment_detection_batch(
                imgs.to(dev), tr.to(dev), cfg, 64, 64,
                draws={k: v.to(dev) for k, v in d.items()})
            hist[dev].append(step(a, t)["loss"].item())
        params[dev] = yolo_mod.params_to_jax(m)
    h_cpu, h_gpu = np.asarray(hist["cpu"]), np.asarray(hist["cuda"])
    loss_rel = float((np.abs(h_gpu - h_cpu) / np.abs(h_cpu)).max())
    check(loss_rel <= 1e-4, f"YOLO train loss card vs CPU: {hist}")
    flat = [{f"{i}/{k}": v for i, p in enumerate(ps) for k, v in p.items()}
            for ps in (w0, params["cpu"], params["cuda"])]
    stats = [k for k in flat[0] if k.endswith(("bn_mean", "bn_var"))]
    train = [k for k in flat[0] if k not in stats]
    update = max(np.abs(flat[1][k] - flat[0][k]).max() for k in train)
    worst = max(np.abs(flat[2][k] - flat[1][k]).max() for k in train)
    check(worst <= 1e-3 * update, f"YOLO params card vs CPU: {worst:.3g} "
          f"against the largest update {update:.3g}")
    worst_stat = max(np.abs(flat[2][k] - flat[1][k]).max()
                     / np.abs(flat[1][k]).max() for k in stats)
    check(worst_stat <= 1e-5, f"YOLO running stats card vs CPU: "
          f"{worst_stat:.3g} of the largest")
    check(not torch.backends.cudnn.allow_tf32,
          "the train step left TF32 on")
    print(f"reference check, float32 YOLO train step (two heads, 64x64, "
          f"batch 3, 3 steps, fixed draws) card vs CPU: loss within "
          f"{loss_rel:.2e} relative, parameters within {worst / update:.2e}"
          f" of the largest update ({update:.3g}), running statistics "
          f"within {worst_stat:.2e} of their largest [{card}]")


# the cut multi-object occlusion tier: 48 cluttered scenes, 300 YOLO and
# 10 KPD iterations per object, 8 eval frames; widths as the tier's own.
# 300 detector steps on 48 scenes box most eval frames of both objects at
# IoU >= 0.5, so that the occlusion CLI grades poses on the card
CUT_OCCL = dict(n_frames=48, n_eval=8, yolo_iters=300, kpd_iters=10,
                kpd_finetune_iters=0)


def phase_cut_occl(torch, np, kernels, card):
    """`tools/occl_multiobj.run_occl_multiobj` cut as CUT_OCCL says, on
    the card: per-object single-class YOLOv3-416 and FastPose trained on
    the cluttered frames, the SIXD tree, the port's occlusion CLI per
    object at capacity 4; decode launched once per object's eval batch
    and held bitwise on each object's heatmaps, [32,26,80,64] (8 frames
    times 4 candidates)."""
    import os
    import tempfile
    from betapose_tpu_torch.ops.kernels import bottleneck_chain as bc
    from betapose_tpu_torch.ops.kernels import heatmap_decode as hd
    from betapose_tpu_torch.tools import occl_multiobj as occl

    hms = []
    with tempfile.TemporaryDirectory() as tmp:
        hd.decode_peaks.launches = 0
        bc.bottleneck_chain.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):     # the CLI's prints
            out = occl.run_occl_multiobj(
                params_dir=os.path.join(tmp, "w"),
                work_dir=os.path.join(tmp, "tree"), device="cuda",
                verbose=False, eval_hook=lambda pipe, frames: hms.append(
                    eval_heatmaps(torch, pipe, frames)), **CUT_OCCL)
        wall = time.perf_counter() - t0
    dec = hd.decode_peaks.launches
    check(dec == 2 and bc.bottleneck_chain.launches == 0 and
          sorted(out) == [1, 2], f"occl_multiobj: decode_peaks launched "
          f"{dec} times for 2 objects' 8 frames, chain "
          f"{bc.bottleneck_chain.launches}")
    kernels["decode_peaks"]["launches_per_path"]["occl_multiobj"] = dec
    kernels["bottleneck_chain"]["launches_per_path"]["occl_multiobj"] = 0
    print(f"cut occl_multiobj (cube + L-wedge + distractor; 48 scenes, 300 "
          f"YOLO and 10 KPD iterations per object, 8 eval frames; the tier:"
          f" 800 scenes, 2000 / 8000 + 3000 iterations, 32 eval frames): "
          f"{wall:.1f} s; " + "; ".join(
              f"obj {k}: ADD<0.1d {v['mean_add']:.3f}, mean ADD "
              f"{v['mean_add_err']:.1f} mm, 2D<20px {v['mean_2d_acc']:.3f}, "
              f"IoU>0.5 {v['mean_iou']:.3f}"
              for k, v in sorted(out.items())) + f" [{card}]")
    # the detectors must find both objects, and the CLI grade their poses
    check(all(v["mean_iou"] > 0 and np.isfinite(v["mean_add_err"])
              for v in out.values()),
          f"occl_multiobj: no pose graded on the card: {out}")
    check(len(hms) == 2 and all(tuple(h.shape) == (32, 26, 80, 64)
                                for h in hms),
          f"occl_multiobj heatmaps {[tuple(h.shape) for h in hms]}")
    for oid, hm in zip(sorted(out), hms):
        hold_decode(torch, hm, kernels["decode_peaks"],
                    f"occl_multiobj obj {oid}", card)


class WindowProfile:
    """A step hook for `tools/selftest.run_selftest`: torch.profiler over
    `n` steps of one training stage, from its step `start` on, with a
    synchronize at each end of the window; `busy` is the device's busy
    share of that window's wall time."""

    def __init__(self, torch, stage, start=200, n=2):
        self.torch, self.stage, self.start, self.n = torch, stage, start, n
        self.prof, self.busy = None, None

    def __call__(self, stage, it):
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        if stage != self.stage:
            return
        if it == self.start - 1:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.t0 = time.perf_counter()
        elif it == self.start + self.n - 1 and self.prof is not None:
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - self.t0) * 1e6
            self.prof.stop()
            self.busy = device_busy_us(torch,
                                       self.prof.key_averages()) / wall_us


def stats_line(stats):
    return (f"detected {stats['n_detected']}/{stats['n_eval']}, "
            f"ADD<0.1d {stats['add_01d_acc']:.3f}, mean ADD "
            f"{stats['mean_add_m'] * 1e3:.3f} mm (median "
            f"{stats['median_add_m'] * 1e3:.3f}), 2D {stats['mean_2d_px']:.3f}"
            f" px (median {stats['median_2d_px']:.3f}), IoU "
            f"{stats['mean_iou']:.3f}")


def eval_heatmaps(torch, pipe, frames):
    """The KPD heatmaps a pipeline's eval computes on `frames`."""
    with torch.inference_mode():
        det = pipe.det_stage(pipe.yolo, pipe.to_device(frames))
        return pipe.pose_stage(pipe.kpd, det["crops"]).float()


# card vs CPU on the reloaded fast tier: mean and median ADD within 0.5 mm
# or 1% (the cube's ADD<0.1d bar is 13.9 mm), 2D error within 0.5 px or 1%
RELOAD_ADD_ATOL, RELOAD_2D_ATOL, RELOAD_RTOL = 5e-4, 0.5, 1e-2


def phase_selftest(torch, np, kernels, card):
    """The accuracy tiers' path: the fast selftest trained on the card in
    a temporary params_dir (60 scenes, 250 YOLO and 1500 KPD iterations,
    8 held-out frames), the decode kernel held on its eval's heatmaps,
    the cache reloaded on the card and on the CPU, then the cut sweep."""
    import os
    import tempfile
    from betapose_tpu_torch.ops.kernels import bottleneck_chain as bc
    from betapose_tpu_torch.ops.kernels import heatmap_decode as hd
    from betapose_tpu_torch.tools import selftest as st

    with tempfile.TemporaryDirectory() as tmp:
        params = os.path.join(tmp, "selftest")
        report, window, hms = {}, WindowProfile(torch, "kpd"), []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hd.decode_peaks.launches = 0
        bc.bottleneck_chain.launches = 0
        t0 = time.perf_counter()
        stats = st.run_selftest(
            params_dir=params, device="cuda", report=report,
            step_hook=window, verbose=False,
            eval_hook=lambda pipe, fr: hms.append(eval_heatmaps(torch, pipe,
                                                                fr)))
        wall = time.perf_counter() - t0
        for name, fn, want in (("decode_peaks", hd.decode_peaks, 1),
                               ("bottleneck_chain", bc.bottleneck_chain, 0)):
            kernels[name].setdefault("launches_per_path", {})[
                "selftest"] = fn.launches
            check(fn.launches == want, f"{name} launched {fn.launches} "
                  f"times on the selftest path (one eval call)")
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(stats["n_eval"] == 8 and np.isfinite(stats["diameter_m"]),
              f"selftest stats {stats}")
        yolo_ms = report["yolo_s"] / 250 * 1e3
        kpd_ms = report["kpd_s"] / 1500 * 1e3
        print(f"selftest (fast tier, trained on the card): render "
              f"{report['render_s']:.2f} s (68 scenes), YOLO "
              f"{yolo_ms:.2f} ms/step, KPD {kpd_ms:.2f} ms/step, KPD busy "
              f"{100 * window.busy:.0f}% (2 profiled steps), eval "
              f"{report['eval_s'] * 1e3:.1f} ms, whole run {wall:.1f} s, "
              f"peak {peak:.2f} GiB; {stats_line(stats)}; decode_peaks "
              f"launched {hd.decode_peaks.launches} time(s) [{card}]")
        print(json.dumps({"selftest": dict(
            stats, render_s=report["render_s"], yolo_ms_per_step=yolo_ms,
            kpd_ms_per_step=kpd_ms, kpd_busy=window.busy, peak_gib=peak,
            wall_s=wall)}))
        hm, = hms
        check(tuple(hm.shape) == (8, 12, 32, 24), f"heatmaps {hm.shape}")
        hold_decode(torch, hm, kernels["decode_peaks"], "selftest", card)

        again = st.run_selftest(params_dir=params, device="cuda",
                                verbose=False)
        check(again["n_detected"] == stats["n_detected"],
              f"the reloaded cache detects {again['n_detected']}, the "
              f"trained run {stats['n_detected']}")
        cpu = st.run_selftest(params_dir=params, device="cpu",
                              verbose=False)
        check(cpu["n_detected"] == again["n_detected"],
              f"reloaded: card detects {again['n_detected']}, CPU "
              f"{cpu['n_detected']}")
        for k, atol in (("mean_add_m", RELOAD_ADD_ATOL),
                        ("median_add_m", RELOAD_ADD_ATOL),
                        ("mean_2d_px", RELOAD_2D_ATOL),
                        ("median_2d_px", RELOAD_2D_ATOL)):
            a, b = again[k], cpu[k]
            check(a == b or abs(a - b) <= max(atol, RELOAD_RTOL * abs(b)),
                  f"reloaded {k}: card {a} vs CPU {b}")
        print(f"selftest cache reloaded (float32, TF32 off): card "
              f"{stats_line(again)}; CPU {stats_line(cpu)}; the trained "
              f"run's ADD {stats['mean_add_m'] * 1e3:.3f} mm [{card}]")
    phase_cut_sweep(torch, np, kernels, card)


# the cut sweep: two objects (one symmetric), 100 scenes, 300 YOLO and 100
# KPD iterations, no fine-tune, 8 eval frames; widths as the sweep's own.
# 300 detector steps are about the fewest after which the 15-class
# YOLOv3-416 boxes every eval frame at IoU >= 0.5, so that ADD-S grades
# poses on the card (100 steps left every objectness under 0.005); the
# KPD is cut to 100 steps to pay for them
CUT_SWEEP = dict(object_names=("cube", "prism"), n_frames=100, n_eval=8,
                 yolo_iters=300, kpd_iters=100, kpd_finetune_iters=0)


def phase_cut_sweep(torch, np, kernels, card):
    """`tools/sweep.run_sweep` cut as CUT_SWEEP says, on the card: the
    15-class YOLOv3 at 416, target_class routing per object, ADD-S on the
    prism; decode launched once per object's eval and held bitwise on
    both objects' eval heatmaps together ([16,26,80,64], the --slow
    tier's shape)."""
    import os
    import tempfile
    from betapose_tpu_torch.ops.kernels import bottleneck_chain as bc
    from betapose_tpu_torch.ops.kernels import heatmap_decode as hd
    from betapose_tpu_torch.tools import sweep

    hms, pipes = [], []

    def hold(pipe, frames):
        pipes.append(pipe)
        hms.append(eval_heatmaps(torch, pipe, frames))

    with tempfile.TemporaryDirectory() as tmp:
        report = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hd.decode_peaks.launches = 0
        bc.bottleneck_chain.launches = 0
        t0 = time.perf_counter()
        out = sweep.run_sweep(params_dir=os.path.join(tmp, "sweep"),
                              device="cuda", verbose=False, report=report,
                              eval_hook=hold,
                              out_json=os.path.join(tmp, "sweep.json"),
                              **CUT_SWEEP)
        wall = time.perf_counter() - t0
        dec = hd.decode_peaks.launches
        with open(os.path.join(tmp, "sweep.json")) as f:
            on_disk = json.load(f)
    check(dec == 2 and bc.bottleneck_chain.launches == 0,
          f"sweep: decode_peaks launched {dec} times for 2 objects, "
          f"bottleneck_chain {bc.bottleneck_chain.launches}")
    kernels["decode_peaks"]["launches_per_path"]["sweep"] = dec
    kernels["bottleneck_chain"]["launches_per_path"]["sweep"] = 0
    check(all(p.yolo.spec.layers[p.yolo.spec.yolo_idxs[0]].num_classes
              == 15 and p.cfg.reso == 416 for p in pipes)
          and [p.cfg.target_class for p in pipes] == [0, 1],
          "sweep: the 15-class 416 detector routed to classes 0 and 1")
    rows = out["per_object"]
    check([r["symmetric"] for r in rows] == [False, True]
          and on_disk["partial"] is False, f"sweep rows {rows}")
    # the detector must find the objects, and ADD-S must grade the
    # symmetric prism's poses on the card
    check(all(r["n_detected"] > 0 for r in rows)
          and np.isfinite(rows[1]["mean_adds_m"])
          and np.isfinite(rows[1]["mean_2d_px_sym"]),
          f"sweep: nothing graded on the card: {rows}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"cut sweep (objects cube, prism; 100 scenes, 300 YOLO and 100 "
          f"KPD iterations, no fine-tune, 8 eval frames; the full sweep: 13 "
          f"objects, 800 scenes, 3000 / 8000 + 3000 iterations, 16 eval "
          f"frames): render {report['render_s']:.1f} s, 15-class YOLOv3-416 "
          f"{report['yolo_s']:.1f} s, KPD {report['kpd_s'][0]:.1f} / "
          f"{report['kpd_s'][1]:.1f} s, whole run {wall:.1f} s, peak "
          f"{peak:.2f} GiB [{card}]")
    for r in rows:
        print(f"  seq {r['seq']:02d} {r['object']:<6} "
              f"{'ADD-S' if r['symmetric'] else 'ADD  '} add_acc "
              f"{r['add_acc']:.3f} adds_acc {r['adds_acc']:.3f} mean ADD "
              f"{r['mean_add_m'] * 1e3:.2f} mm ADD-S "
              f"{r['mean_adds_m'] * 1e3:.2f} mm 2D {r['mean_2d_px']:.2f} "
              f"(sym {r['mean_2d_px_sym']:.2f}) px IoU {r['mean_iou']:.3f} "
              f"det {r['n_detected']}/{r['n_eval']}")
    hm = torch.cat(hms)
    check(tuple(hm.shape) == (16, 26, 80, 64), f"sweep heatmaps {hm.shape}")
    hold_decode(torch, hm, kernels["decode_peaks"], "sweep", card)
    phase_cut_occl(torch, np, kernels, card)


def phase_probe_path(torch, kernels, card):
    """The probe path through its entry point, then the kernel's times."""
    from betapose_tpu_torch.ops.kernels import bottleneck_chain as bc
    from betapose_tpu_torch.ops.kernels import heatmap_decode as hd
    from betapose_tpu_torch.tools import probe_vmem_chain as pvc

    bc.bottleneck_chain.launches = 0
    hd.decode_peaks.launches = 0
    t0 = time.perf_counter()
    rows = pvc.main(["--batch", "96", "--k", "5", "--rounds", "3"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bc.bottleneck_chain.launches
    calls = sum(r["kernel_calls"] for r in rows)
    check(launches == calls and launches > 0,
          f"bottleneck_chain launched {launches} times on the probe path, "
          f"which made {calls} kernel calls")
    print(f"probe path: {len(rows)} shapes in {wall:.1f} s, "
          f"bottleneck_chain launched {launches} times ({calls} calls) "
          f"[{card}]")

    rec = kernels["bottleneck_chain"]
    rec["launches"] = launches
    per_shape = []
    for shape in CHAIN_PROBE:
        x, w1, w2, w3 = pvc.chain_inputs(*shape, "cuda")
        convw = pvc.chain_conv_weights(w1, w2, w3)
        k_ms, k_eager = time_ms(torch, lambda: bc.bottleneck_chain(
            x, w1, w2, w3), reps=10, rounds=5)
        p_ms, _ = time_ms(torch, lambda: bc.bottleneck_chain_plain(
            x, w1, w2, w3), reps=10, rounds=5)
        c_ms, _ = time_ms(torch, lambda: pvc.bottleneck_chain_cudnn(
            x, *convw), reps=10, rounds=5)
        flops = bc.chain_flops(*shape)
        n_bytes = 2 * (2 * x.numel() + w1.numel() + w2.numel() + w3.numel())
        t_ops, t_bytes = flops / BF16_FLOPS, n_bytes / HBM_BYTES_PER_S
        plan = bc.kernel_plan(*shape)
        per_shape.append({
            "shape": "x".join(map(str, shape[:4])) + f"->cm{shape[4]}",
            "ms": k_ms, "plain_ms": p_ms, "library_ms": c_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "tile": list(plan["tile"]), "blocks": plan["blocks"],
            "widths": list(plan["widths"])})
        print(f"bottleneck_chain {list(shape)}: device time kernel "
              f"{k_ms:.4f} ms (eager {k_eager:.4f} ms), plain f32 "
              f"{p_ms:.4f} ms, cuDNN chain {c_ms:.4f} ms; bound "
              f"{per_shape[-1]['bound_ms']:.4f} ms "
              f"({per_shape[-1]['bound_by']}: {flops / 1e9:.1f} GFLOP, "
              f"{n_bytes / 1e6:.1f} MB); {flops / k_ms / 1e9:.1f} TFLOP/s "
              f"= {100 * flops / k_ms / 1e9 / 989:.1f}% of 989; tile "
              f"{plan['tile']}, {plan['blocks']} blocks, widths "
              f"{plan['widths']} [{card}]")
    # the line's own numbers are those of the first (largest) shape
    rec.update({k: per_shape[0][k] for k in
                ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    rec["shape"] = per_shape[0]["shape"]
    rec["per_shape"] = per_shape


def phase_s2d_stem(torch, np, pipe, frames, card):
    """The s2d stem against the plain stem: float32 agreement on the card,
    then both timed in bf16 on the main path's network."""
    import dataclasses
    from betapose_tpu_torch.core.profiling import chain_ms
    from betapose_tpu_torch.eval.pipeline import make_det_stage
    from betapose_tpu_torch.models import stem_s2d
    from betapose_tpu_torch.models import yolov3 as yolo_mod
    from betapose_tpu_torch.models.darknet_cfg import make_yolov3_cfg
    from betapose_tpu_torch.ops.image import resize_bilinear_matmul

    spec = yolo_mod.build_spec(make_yolov3_cfg(1, 416, 416))
    yolo = yolo_mod.fold_bn(yolo_mod.Darknet(
        spec, 416, torch.Generator().manual_seed(0))).cuda()
    calibrate_yolo_heads(torch, yolo, torch.as_tensor(frames).cuda(), 416)
    cfg32 = dataclasses.replace(pipe.cfg, compute_dtype="float32")
    fdev = torch.as_tensor(frames[:4]).cuda()
    with torch.inference_mode():
        x = resize_bilinear_matmul(fdev.float() / 255.0, 416, 416)
        plain = yolo(x, decode=False)
        fast = stem_s2d.forward_with_s2d_stem(yolo, x, decode=False)
        worst = 0.0
        for a, b in zip(fast, plain):
            bad = ((a - b).abs() > 1e-3 + 1e-2 * b.abs()).float().mean()
            worst = max(worst, bad.item())
        check(worst < 0.005, f"s2d stem raw heads: {worst:.4f} of entries "
              f"outside 1e-3 + 1e-2|ref|")
        dets = [make_det_stage(dataclasses.replace(cfg32, s2d_stem=s))(
            yolo, fdev) for s in (False, True)]
        check(torch.equal(dets[0]["det_valid"], dets[1]["det_valid"]),
              "s2d stem changes det_valid")
        box_err = (dets[0]["boxes"] - dets[1]["boxes"]).abs().max().item()
        check(box_err < 1.0, f"s2d stem moves boxes by {box_err:.3g} px")
    print(f"s2d stem, float32 det stage at reso 416 (4 frames): raw heads "
          f"{100 * worst:.3f}% of entries outside 1e-3 + 1e-2|ref| (bar "
          f"0.5%), det_valid equal, boxes within {box_err:.2e} px")

    # bf16, the main path's network and frames (batch 8)
    with torch.inference_mode():
        fdev = pipe.to_device(frames)
        x = resize_bilinear_matmul(fdev.to(torch.bfloat16) / 255.0, 416,
                                   416)
        fwd = {"plain": lambda: pipe.yolo(x, decode=False),
               "s2d": lambda: stem_s2d.forward_with_s2d_stem(
                   pipe.yolo, x, decode=False)}
        times = {k: time_ms(torch, f, reps=10, rounds=5)[0]
                 for k, f in fwd.items()}
        stages = {k: chain_ms(lambda s=make_det_stage(dataclasses.replace(
            pipe.cfg, s2d_stem=(k == "s2d"))): s(pipe.yolo, fdev), "cuda",
            k=10, rounds=5) for k in ("plain", "s2d")}
    print(f"s2d stem, bf16 at batch 8: YOLO forward (raw heads, CUDA-graph "
          f"replay) plain {times['plain']:.4f} ms, s2d {times['s2d']:.4f} "
          f"ms; det stage (eager calls between CUDA events) plain "
          f"{stages['plain']:.4f} ms, s2d {stages['s2d']:.4f} ms [{card}]")


def old_conv_layer_forward(self, x):
    """The port's YOLO layer before it rounded once (kept here only to
    measure the repair): on a network cast to bf16, cuDNN's bf16 conv
    output, the folded bias added in bf16, the leaky in bf16."""
    import torch.nn.functional as F
    y = self.conv(x)
    if self.bn is not None:
        y = self.bn(y)
    if self.activation == "leaky":
        y = F.leaky_relu(y, 0.1)
    return y


def ulp_steps(torch, got, ref):
    """bf16 steps between got and ref, per element (on the CPU)."""
    def keys(t):
        v = t.cpu().to(torch.bfloat16).view(torch.int16).int()
        return torch.where(v < 0, -(v & 0x7FFF), v)
    return (keys(got) - keys(ref)).abs()


def phase_yolo_rounding(torch, np, pipe, frames, card):
    """YOLO's bf16 layers round once: the card against the CPU per layer,
    then the forward and the det stage with the old layer and the new."""
    import copy
    import dataclasses
    from unittest import mock
    from betapose_tpu_torch.eval.pipeline import make_det_stage
    from betapose_tpu_torch.models import yolov3 as yolo_mod
    from betapose_tpu_torch.ops.image import resize_bilinear_matmul

    # two layers (the first, 3->32 at 416^2, and a 3x3 512->1024 one) on
    # bf16 inputs: the card's TF32 conv of bf16 values against the CPU's
    # float32 conv, which forms the same exact products
    layers = yolo_mod.conv_layers(pipe.yolo)
    gen = torch.Generator().manual_seed(5)
    for idx in (0, max(range(len(layers)),
                       key=lambda i: layers[i][0].in_channels
                       * (layers[i][0].size == 3))):
        spec, layer = layers[idx]
        hw = 416 if idx == 0 else 13
        x = torch.randn((2, spec.in_channels, hw, hw), generator=gen)
        x = x.to(torch.bfloat16)
        cpu_layer = copy.deepcopy(layer).cpu()
        with torch.inference_mode():
            got = layer(x.cuda().to(memory_format=torch.channels_last))
            ref = cpu_layer(x)
        check(got.dtype == torch.bfloat16, "bf16 layer output dtype")
        steps = ulp_steps(torch, got, ref)
        diff = (got.cpu().float() - ref.float()).abs()
        # the two float32 sums differ in order only: a rounding flips by 1
        # ulp now and then, more often the longer the sum (0.3% of outputs
        # at K = 4608), and by more only where the sum cancels to near zero
        near = diff <= 1e-5 * ref.float().abs().max()
        equal = (steps == 0).float().mean().item()
        check(equal >= 0.99 and bool(((steps <= 1) | near).all()),
              f"YOLO layer {idx} in bf16, card vs CPU: {equal:.5f} bitwise "
              f"equal, {int(((steps > 1) & ~near).sum())} outputs more than "
              f"1 ulp apart")
        print(f"YOLO bf16 layer {idx} ({spec.in_channels}->"
              f"{spec.out_channels}, {spec.size}x{spec.size}, {hw}^2) card "
              f"vs CPU: {100 * equal:.3f}% of outputs bitwise equal, "
              f"{int((steps > 1).sum())} more than 1 ulp apart, all of "
              f"them within 1e-5 of max|ref|")

    old_yolo = copy.deepcopy(pipe.yolo).to(torch.bfloat16)
    old = mock.patch.object(yolo_mod.ConvLayer, "forward",
                            old_conv_layer_forward)
    fdev = pipe.to_device(frames)
    times = {}
    with torch.inference_mode():
        x = resize_bilinear_matmul(fdev.to(torch.bfloat16) / 255.0, 416, 416)
        fwd = {"old": lambda: old_yolo(x, decode=False),
               "new": lambda: pipe.yolo(x, decode=False)}
        for name in ("old", "new", "new", "old"):
            with old if name == "old" else contextlib.nullcontext():
                times.setdefault(name, []).append(
                    time_ms(torch, fwd[name], reps=10, rounds=5))
        cfg32 = dataclasses.replace(pipe.cfg, compute_dtype="float32")
        dets = {"new": pipe.det_stage(pipe.yolo, fdev),
                "f32": make_det_stage(cfg32)(pipe.yolo, fdev)}
        heads = {"new": fwd["new"](),
                 "f32": pipe.yolo(resize_bilinear_matmul(
                     fdev.float() / 255.0, 416, 416), decode=False)}
        with old:
            dets["old"] = pipe.det_stage(old_yolo, fdev)
            heads["old"] = fwd["old"]()
    torch.cuda.synchronize()
    ref = torch.cat([h.float().flatten() for h in heads["f32"]])
    for name in ("old", "new"):
        got = torch.cat([h.float().flatten() for h in heads[name]])
        print(f"YOLO raw heads in bf16 ({name} layer) against the float32 "
              f"network on the same {len(frames)} frames: relative RMS "
              f"difference "
              f"{((got - ref).norm() / ref.norm()).item():.3e}, max "
              f"{((got - ref).abs().max() / ref.abs().max()).item():.3e} of "
              f"max|f32|")

    def moved(a, b):
        valid = int((dets[a]["det_valid"] != dets[b]["det_valid"]).sum())
        d = (dets[a]["boxes"] - dets[b]["boxes"]).abs().amax(dim=1)
        return valid, int((d > 1.0).sum()), d.max().item()

    for name in ("old", "new"):
        g = [t[0] for t in times[name]]
        e = [t[1] for t in times[name]]
        print(f"YOLO forward bf16 at batch {len(frames)} ({name} layer): "
              f"CUDA-graph "
              f"replay {g[0]:.4f} / {g[1]:.4f} ms, eager {e[0]:.4f} / "
              f"{e[1]:.4f} ms (two turns: old, new, new, old) [{card}]")
    for a, b in (("old", "new"), ("old", "f32"), ("new", "f32")):
        valid, boxes, worst = moved(a, b)
        print(f"det stage on the same {len(frames)} frames, {a} against "
              f"{b}: det_valid differs in {valid}, the best box moves by "
              f"more than 1 px in {boxes} (at most {worst:.3g} px)")


def phase_tools(card):
    """The other tools once each, at reduced iterations."""
    from betapose_tpu_torch.tools import (probe_conv_mfu, probe_s2d_stage,
                                          profile_pipeline)
    t0 = time.perf_counter()
    prof = profile_pipeline.main(["--batch", "8", "--iters", "3"])
    check(prof["fps"] > 0, "profile_pipeline")
    prof = profile_pipeline.main(["--batch", "8", "--iters", "3",
                                  "--det_capacity", "4"])
    check(prof["fps"] > 0, "profile_pipeline --det_capacity 4")
    mfu = probe_conv_mfu.main(["--k", "10", "--rounds", "3"])
    check(len(mfu) == 6, "probe_conv_mfu rows")
    s2d = probe_s2d_stage.main(["--k", "5", "--rounds", "3"])
    check(len(s2d) == 2, "probe_s2d_stage rows")
    print(f"tools: profile_pipeline (capacity 1 and 4), probe_conv_mfu, "
          f"probe_s2d_stage ran in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")


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

    # the multi-candidate path in float32, both modes: the det stage on the
    # card against the CPU, then the CPU's heatmaps and candidates through
    # both post stages
    import dataclasses
    from betapose_tpu_torch.eval.pipeline import to_numpy
    for path, host in (("device", False), ("host", True)):
        mcfg = dataclasses.replace(cfg, host_pose_nms=host,
                                   **OCCLUSION_RECIPE)
        mp = [PosePipeline(p.yolo, p.kpd, kp3d, np.asarray(CAM_K), mcfg,
                           device=p.device) for p in (cpu, gpu)]
        with torch.inference_mode():
            mdets = [m.det_stage(m.yolo, m.to_device(frames)) for m in mp]
            check(torch.equal(mdets[0]["det_valid"],
                              mdets[1]["det_valid"].cpu()),
                  f"multi ({path}): det_valid differs, card vs CPU")
            mbox = (mdets[0]["boxes"] - mdets[1]["boxes"].cpu()).abs().max()
            check(mbox < 1e-2, f"multi ({path}): boxes differ by {mbox:.3g}")
            mhm = mp[0].pose_stage(mp[0].kpd, mdets[0]["crops"])
            ins = [(mhm, mdets[0]),
                   (mhm.cuda(), {k: v.cuda() for k, v in mdets[0].items()})]
            mouts = [to_numpy(m._post_device(m._device_outputs(h, d)))
                     for m, (h, d) in zip(mp, ins)]
        check(all(np.array_equal(mouts[0][k], mouts[1][k])
                  for k in ("det_valid", "pose_valid", "boxes")),
              f"multi ({path}): det_valid, pose_valid or boxes differ after "
              f"pose-NMS, card vs CPU")
        mkp = np.abs(mouts[0]["keypoints"] - mouts[1]["keypoints"]).max()
        check(mkp < 1e-3, f"multi ({path}): keypoints differ by {mkp:.3g}")
        v = mouts[0]["pose_valid"]
        mt = (np.abs(mouts[0]["cam_t"][v] - mouts[1]["cam_t"][v])
              / np.maximum(np.abs(mouts[0]["cam_t"][v]), 1e-3))
        mt = float(mt.max()) if v.any() else 0.0
        check(mt <= 1e-2, f"multi ({path}): cam_t differs by {mt:.3g} "
              f"(relative), card vs CPU")
        print(f"reference check, float32 multi-candidate ({path} pose-NMS, "
              f"capacity {OCCLUSION_RECIPE['det_capacity']}) card vs CPU at "
              f"reso 64: boxes within {mbox:.2e} px, det_valid and pose_valid"
              f" equal ({int(v.sum())} valid), keypoints within {mkp:.2e} px,"
              f" cam_t within {mt:.2e} relative")

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
            # ptxas: registers, spills, and any advisory (a serialized wgmma)
            if any(k in line for k in ("registers", "spill", "Performance")):
                print(f"  {src}: {line.strip()}")

    kernels = {"decode_peaks": {
        "name": "decode_peaks", "route": "cuda",
        "source": "betapose_tpu_torch/csrc/heatmap_decode.cu",
        "replaces": "betapose_tpu/ops/pallas/heatmap_decode.py:77",
        "launches": 0, "max_abs_err": None, "ms": None, "plain_ms": None,
        "bound_ms": None, "bound_by": "bytes", "library_ms": None,
        "library_note": "none: no single PyTorch call computes the decode"},
        "bottleneck_chain": {
        "name": "bottleneck_chain", "route": "cuda",
        "source": "betapose_tpu_torch/csrc/bottleneck_chain.cu",
        "replaces": "betapose_tpu/ops/pallas/bottleneck_chain.py:102",
        "launches": 0, "max_abs_err": None, "ms": None, "plain_ms": None,
        "bound_ms": None, "bound_by": "operations", "library_ms": None,
        "library_note": "the cuDNN chain, not one call: three F.conv2d "
                        "(bf16, channels_last), relu and the residual add "
                        "(tools/probe_vmem_chain.bottleneck_chain_cudnn)"}}

    phase_kernels(torch, np, kernels)
    phase_chain_kernel(torch, kernels)
    pipe, frames = phase_main_path(torch, np, kernels, card,
                                   args.profile_out)
    phase_multi_path(torch, np, kernels, pipe, frames, card,
                     args.profile_out)
    phase_hgprm_path(torch, np, kernels, pipe, frames, card,
                     args.profile_out)
    phase_reference(torch, np)
    phase_hgprm_reference(torch, np)
    phase_kpd_train(torch, np, kernels, card, args.profile_out)
    phase_yolo_train(torch, np, kernels, card, args.profile_out)
    phase_selftest(torch, np, kernels, card)
    phase_probe_path(torch, kernels, card)
    phase_s2d_stem(torch, np, pipe, frames, card)
    phase_yolo_rounding(torch, np, pipe, frames, card)
    phase_tools(card)

    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
