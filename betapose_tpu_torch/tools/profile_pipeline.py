"""Where the pose step's time goes on the card: per-stage times and FLOPs.

Counterpart of `betapose_tpu/tools/profile_pipeline.py`.  Builds YOLOv3
(1 class) and FastPose (50 keypoints) with seeded random weights (batch
norm folded, YOLO heads scaled to unit spread so random boxes stay
finite), feeds `PosePipeline` frames made from `--seed`, and prints one
JSON document:

- `step_ms_per_batch` / `fps`: `PosePipeline.__call__` (host frames in,
  device results out), wall clock over `--iters` calls ending in a
  synchronize;
- `stage_ms`: dt / pt / pn through `PosePipeline.profiled_call`, which
  synchronizes at each stage's end;
- `sub_ms`: resize, YOLO forward (with the s2d stem under `--s2d_stem`),
  KPD forward, crop, decode and PnP, each timed alone as device time
  (`core/profiling.chain_ms`), so their sum need not equal the step;
- `flops_per_batch`: matmul and conv FLOPs of the step and of the det and
  pose stages (`torch.utils.flop_counter.FlopCounterMode`; PnP's SVD and
  QR are not counted), and `mfu_step` against the H100 SXM dense bf16 peak
  (989 TFLOP/s, NVIDIA data sheet).

`--det_capacity N` > 1 profiles the multi-candidate step (device
pose-NMS): the KPD, the decode and the crop's batch are B*N crops; the
crop sub-time takes each frame's candidate 0 and PnP the first B decoded
crops, as the JAX tool does.  `--trace DIR` writes a torch.profiler chrome
trace of one step (`core/profiling.device_trace`).

Run on the card:
    python -m betapose_tpu_torch.tools.profile_pipeline [--batch 64]
`--device cpu` is for the tests (which also shrink `SIZES`).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from betapose_tpu_torch.core.device import resolve_device, synchronize
from betapose_tpu_torch.core.profiling import (RuntimeProfile, chain_ms,
                                               device_trace)
from betapose_tpu_torch.eval.pipeline import PipelineConfig, PosePipeline
from betapose_tpu_torch.models import kpd as kpd_mod
from betapose_tpu_torch.models import stem_s2d
from betapose_tpu_torch.models import yolov3 as yolo_mod
from betapose_tpu_torch.models.darknet_cfg import make_yolov3_cfg
from betapose_tpu_torch.ops import heatmap as hm_ops
from betapose_tpu_torch.ops import image as image_ops
from betapose_tpu_torch.ops import pnp as pnp_ops
from betapose_tpu_torch.tools.probe_vmem_chain import PEAK_BF16, PEAK_NAME

CAM_K = np.array([[572.4114, 0.0, 325.2611],
                  [0.0, 573.57043, 242.04899], [0.0, 0.0, 1.0]])
# the pipeline's shapes: YOLO input, KPD crop (H, W), backbone, frame (H, W)
SIZES = {"reso": 416, "crop": (320, 256), "arch": "resnet101",
         "frame": (480, 640)}


def calibrate_heads(model, x):
    """Scale each head conv of the Darknet `model` so that its raw output
    has unit spread on the network input x (NHWC).  A random He-initialized
    YOLOv3 drives its heads to ~1e4, where exp(tw) overflows and every box
    is infinite; trained weights do not.  For seeded random weights only."""
    with torch.inference_mode():
        heads = model(x, decode=False)
        spread = [h.float().std().item() for h in heads]
    with torch.no_grad():
        for i, s in zip(model.spec.yolo_idxs, spread):
            conv = model.layers[i - 1].conv
            conv.weight.mul_(1.0 / s)
            conv.bias.mul_(1.0 / s)
    return model


def build_pipeline(cfg, frames, device, seed):
    """PosePipeline over seeded random networks, BN folded, the YOLO heads
    calibrated on `frames` (uint8 NHWC, numpy)."""
    spec = yolo_mod.build_spec(make_yolov3_cfg(1, cfg.reso, cfg.reso))
    yolo = yolo_mod.fold_bn(yolo_mod.Darknet(
        spec, cfg.reso, torch.Generator().manual_seed(seed)))
    with torch.no_grad():
        x = image_ops.resize_bilinear_matmul(
            torch.from_numpy(frames[:8]).float() / 255.0, cfg.reso, cfg.reso)
    calibrate_heads(yolo, x)
    kpd = kpd_mod.fold_bn(kpd_mod.FastPose(
        cfg.n_kp, cfg.net_type, torch.Generator().manual_seed(seed + 1)))
    kp3d = np.random.default_rng(seed).standard_normal((cfg.n_kp, 3)) * 0.05
    return PosePipeline(yolo, kpd, kp3d, CAM_K, cfg, device=device)


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--det_capacity", type=int, default=1)
    ap.add_argument("--s2d_stem", action="store_true",
                    help="run YOLO's stem through the space-to-depth rewrite")
    ap.add_argument("--trace", default=None,
                    help="write a torch.profiler chrome trace of one step "
                         "into this directory")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the frames and the random weights")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    inp_h, inp_w = SIZES["crop"]
    cfg = PipelineConfig(
        reso=SIZES["reso"], inp_h=inp_h, inp_w=inp_w, out_h=inp_h // 4,
        out_w=inp_w // 4, s2d_stem=args.s2d_stem, net_type=SIZES["arch"],
        det_capacity=args.det_capacity,
        compute_dtype="bfloat16" if on_card else "float32")
    b = args.batch
    rng = np.random.default_rng(args.seed)
    frames = rng.integers(0, 256, (b, *SIZES["frame"], 3), dtype=np.uint8)
    pipe = build_pipeline(cfg, frames, device, args.seed)

    # ---- the step, host frames in ----
    pipe(frames)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = pipe(frames)
    synchronize(device)
    step_s = (time.perf_counter() - t0) / args.iters
    if not all(torch.isfinite(v.float()).all() for v in out.values()):
        raise RuntimeError("the step gave non-finite outputs")

    if args.trace:
        with device_trace(args.trace):
            pipe(frames)
            synchronize(device)

    # ---- dt / pt / pn ----
    prof = RuntimeProfile()
    pipe.profiled_call(frames, RuntimeProfile())
    for _ in range(args.iters):
        pipe.profiled_call(frames, prof)

    # ---- the parts, each alone ----
    sub = {}
    with torch.inference_mode():
        fdev = pipe.to_device(frames)
        imgs = fdev.to(getattr(torch, cfg.compute_dtype)) / 255.0

        def ms(fn):
            return chain_ms(fn, device, k=args.iters, rounds=3, warmup=1)
        sub["resize_ms"] = ms(lambda: image_ops.resize_bilinear_matmul(
            imgs, cfg.reso, cfg.reso))
        yolo_in = image_ops.resize_bilinear_matmul(imgs, cfg.reso, cfg.reso)
        sub["yolo_fwd_ms"] = ms(
            (lambda: stem_s2d.forward_with_s2d_stem(pipe.yolo, yolo_in))
            if args.s2d_stem else (lambda: pipe.yolo(yolo_in)))
        det = pipe.det_stage(pipe.yolo, fdev)
        sub["kpd_fwd_ms"] = ms(lambda: pipe.kpd(det["crops"]))
        boxes0 = det["boxes"] if args.det_capacity == 1 else \
            det["boxes"][:, 0]
        sub["crop_ms"] = ms(lambda: image_ops.crop_from_dets(
            imgs, boxes0, cfg.inp_h, cfg.inp_w))
        hm = pipe.pose_stage(pipe.kpd, det["crops"])

        def decode():
            return hm_ops.decode_heatmaps(hm, det["pt1"], det["pt2"],
                                          cfg.inp_h, cfg.inp_w, cfg.out_h,
                                          cfg.out_w)
        sub["decode_ms"] = ms(decode)
        kp2d = decode()[1][:b]
        kp3d_b = pipe.kp3d[None].expand(b, -1, -1)
        sub["pnp_ms"] = ms(lambda: pnp_ops.solve_pnp(
            kp3d_b, kp2d, pipe.cam_K, iters=cfg.pnp_iters))

        flops = {"step": _flops(lambda: pipe(frames)),
                 "det": _flops(lambda: pipe.det_stage(pipe.yolo, fdev)),
                 "pose": _flops(lambda: pipe.pose_stage(pipe.kpd,
                                                        det["crops"]))}
    result = {
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "batch": b,
        "det_capacity": args.det_capacity,
        "s2d_stem": args.s2d_stem,
        "step_ms_per_batch": round(step_s * 1e3, 3),
        "fps": round(b / step_s, 2),
        "stage_ms": {k: round(prof.mean(k) * 1e3, 3)
                     for k in ("dt", "pt", "pn")},
        "sub_ms": {k: round(v, 4) for k, v in sub.items()},
        "flops_per_batch": flops,
        "mfu_step": (round(flops["step"] / step_s / PEAK_BF16, 4)
                     if on_card else None),
        "mfu_peak": PEAK_NAME,
        "note": ("stage_ms synchronizes between stages; sub_ms are device "
                 "times of each part alone, so sums can differ from "
                 "step_ms_per_batch"),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
