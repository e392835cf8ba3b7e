"""The port's entry point: the capacity-1 pose step and example arguments.

Counterpart of `__graft_entry__.entry()`: YOLOv3-416 (1 class) and
FastPose SE-ResNet101 (50 keypoints) on seeded weights, batch 4 of
480x640 uint8 frames, the LineMod camera.  `fn(*example_args)` runs one
fused step (detect -> crop -> KPD -> peak decode -> PnP) and returns the
per-frame outputs.  It runs on the card unless `device="cpu"`; the
networks' batch norms are folded and the conv path runs bf16 on the card,
float32 on the CPU, as the eval CLI runs them.

    from betapose_tpu_torch.entry import entry
    fn, args = entry()
    out = fn(*args)

The JAX package's `dryrun_multichip` waits for the port's data
parallelism (ROADMAP Queue 1, slice 6).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.device import resolve_device
from .eval.pipeline import PipelineConfig, PosePipeline, make_pose_step
from .models import kpd as kpd_mod
from .models import yolov3 as yolo_mod
from .models.darknet_cfg import make_yolov3_cfg

CAM_K = np.array([[572.4114, 0.0, 325.2611],
                  [0.0, 573.57043, 242.04899],
                  [0.0, 0.0, 1.0]], np.float32)


def entry(device=None, cfg: PipelineConfig | None = None, yolo_cfg=None,
          arch="resnet101"):
    """Returns (fn, example_args) with example_args = (yolo, kpd, frames,
    kp3d, cam_K) on `device` (None: the card).  cfg: the pipeline's
    options (default: the main path's, with the conv path in bf16 on the
    card and float32 on the CPU); yolo_cfg: a darknet cfg text (default:
    YOLOv3 at cfg.reso, 1 class).  The networks are seeded (YOLO from
    seed 0, FastPose from seed 1: He-normal convs, identity batch norm)
    and folded; the keypoint model is the JAX entry's."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = PipelineConfig(
            compute_dtype="bfloat16" if dev.type == "cuda" else "float32")
    spec = yolo_mod.build_spec(yolo_cfg or make_yolov3_cfg(
        num_classes=1, width=cfg.reso, height=cfg.reso))
    yolo = yolo_mod.Darknet(spec, cfg.reso, torch.Generator().manual_seed(0))
    kpd = kpd_mod.FastPose(cfg.n_kp, arch, torch.Generator().manual_seed(1))
    kp3d = np.random.default_rng(0).standard_normal((cfg.n_kp, 3)) * 0.05
    pipe = PosePipeline(yolo_mod.fold_bn(yolo), kpd_mod.fold_bn(kpd), kp3d,
                        CAM_K, dataclasses.replace(cfg, net_type=arch),
                        device=dev)
    step = make_pose_step(pipe.cfg)

    def fn(yolo, kpd, frames, kp3d, cam_K):
        with torch.inference_mode():
            return step(yolo, kpd, frames, kp3d, cam_K)

    frames = torch.zeros((4, 480, 640, 3), dtype=torch.uint8, device=dev)
    return fn, (pipe.yolo, pipe.kpd, frames, pipe.kp3d, pipe.cam_K)
