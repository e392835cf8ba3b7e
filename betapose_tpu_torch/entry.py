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

`dryrun_multichip(n)` is the counterpart of `__graft_entry__.
dryrun_multichip`: train and serve steps over an n-rank mesh of CPU
processes (gloo), on tiny shapes, printing one line.
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


DRYRUN_YOLO_CFG = """
[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=18
activation=linear

[yolo]
mask = 0,1,2
anchors = 10,13,  16,30,  33,23
classes=1
num=3
ignore_thresh = .7
"""
DRYRUN_KP = 4
DRYRUN_CAM_K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1.0]])


def dryrun_kpd_batch(rng, b, h=64, w=32, n_kp=DRYRUN_KP):
    """The dryrun's KPD batch: normal inputs [b,h,w,3], gaussian labels
    at uniform points, a mask of ones (NCHW maps, `augment_batch`'s)."""
    from .ops.heatmap import draw_gaussian_batch
    pts = rng.random((b, n_kp, 2)).astype(np.float32) * [w // 4, h // 4]
    labels = draw_gaussian_batch(torch.from_numpy(pts), h // 4, w // 4, 1)
    return {"inps": torch.from_numpy(
                rng.standard_normal((b, h, w, 3)).astype(np.float32)),
            "labels": labels, "set_mask": torch.ones_like(labels)}


def dryrun_kpd_step(mesh, batch, model_parallel=False):
    """One adam KPD step (resnet50, 4 keypoints, seed 0) on this rank's
    rows of `batch` over the mesh's `data` axis, the network tensor-
    parallel over `model` when asked; (model, loss) with mesh None: the
    single-process step on the whole batch."""
    from .parallel import layers
    from .parallel import mesh as mesh_mod
    from .train import kpd_train
    model = kpd_mod.FastPose(DRYRUN_KP, "resnet50",
                             torch.Generator().manual_seed(0))
    group = None
    if mesh is not None:
        group = mesh_mod.axis_group(mesh, "data")
        if model_parallel:
            model = layers.tensor_parallel(
                model, mesh_mod.axis_group(mesh, "model"))
        layers.set_batch_norm_group(model, group)
        batch = mesh_mod.shard_batch(mesh, batch)
    opt = kpd_train.make_optimizer(model.parameters(), "adam", 1e-3)
    # float32: XLA:CPU runs the JAX dryrun's "bfloat16" convs in float32
    step = kpd_train.make_train_step(model, opt, 16, "float32", group=group)
    return model, float(step(batch)["loss"])


def dryrun_yolo_step(mesh, imgs, truths):
    """One SGD step of the tiny darknet cfg (seed 1) at 64x64, data-
    parallel over the mesh's `data` axis (single-process with mesh None);
    (model, loss)."""
    from .parallel import layers
    from .parallel import mesh as mesh_mod
    from .train import yolo_train
    spec = yolo_mod.build_spec(DRYRUN_YOLO_CFG)
    model = yolo_mod.Darknet(spec, 64, torch.Generator().manual_seed(1))
    group = None
    if mesh is not None:
        group = mesh_mod.axis_group(mesh, "data")
        layers.set_batch_norm_group(model, group)
        imgs, truths = mesh_mod.shard_batch(mesh, (imgs, truths))
    ycfg = yolo_train.YoloTrainConfig(lr=1e-3, burn_in=0, steps=(10 ** 6,),
                                      scales=(0.1,))
    step = yolo_train.make_train_step(
        model, yolo_train.make_optimizer(model, ycfg), 64, 64, "float32",
        group)
    return model, float(step(imgs, truths)["loss"])


def dryrun_inputs(n):
    """The dryrun's data, drawn as the JAX dryrun draws its own (numpy
    seed 0): the KPD batch, the YOLO images and truths, the DP x TP KPD
    batch, the keypoint model, the eval frames."""
    rng = np.random.default_rng(0)
    b = 2 * n
    kpd_batch = dryrun_kpd_batch(rng, b)
    imgs = torch.from_numpy(rng.random((b, 64, 64, 3)).astype(np.float32))
    truths = torch.zeros((b, 4, 5))
    truths[:, 0] = torch.tensor([0.5, 0.5, 0.3, 0.3, 0.0])
    tp_batch = dict(kpd_batch, inps=torch.from_numpy(
        rng.standard_normal((b, 64, 32, 3)).astype(np.float32)))
    kp3d = rng.standard_normal((DRYRUN_KP, 3)) * 0.05
    frames = rng.integers(0, 255, (b, 48, 64, 3)).astype(np.uint8)
    return kpd_batch, imgs, truths, tp_batch, kp3d, frames


def _dryrun_rank(n):
    from .parallel import mesh as mesh_mod
    from .parallel.inference import ShardedPosePipeline
    kpd_batch, imgs, truths, tp_batch, kp3d, frames = dryrun_inputs(n)
    mesh = mesh_mod.make_mesh(n)
    kpd, kpd_loss = dryrun_kpd_step(mesh, kpd_batch)
    yolo, yolo_loss = dryrun_yolo_step(mesh, imgs, truths)
    assert np.isfinite([kpd_loss, yolo_loss]).all(), (kpd_loss, yolo_loss)
    tp_msg = ""
    if n >= 4 and n % 2 == 0:
        _, tp_loss = dryrun_kpd_step(mesh_mod.make_mesh(n, model_parallel=2),
                                     tp_batch, model_parallel=True)
        assert np.isfinite(tp_loss), tp_loss
        tp_msg = f" dpxtp_kpd_loss={tp_loss:.6f}"
    # the sharded multi-candidate eval (device pose-NMS) over the DP mesh
    ecfg = PipelineConfig(reso=64, inp_h=64, inp_w=32, out_h=16, out_w=8,
                          n_kp=DRYRUN_KP, left_keypoints=DRYRUN_KP,
                          compute_dtype="float32", det_capacity=3,
                          confidence=0.0)
    yolo_f, kpd_f = yolo_mod.fold_bn(yolo), kpd_mod.fold_bn(kpd)
    out = ShardedPosePipeline(yolo_f, kpd_f, kp3d, DRYRUN_CAM_K, ecfg,
                              mesh=mesh, device="cpu")(frames)
    assert torch.isfinite(out["proposal_score"]).all()
    sp_msg = ""
    if n >= 2:   # one frame's rows over every rank
        smesh = mesh_mod.make_mesh(n, spatial_parallel=n)
        out = ShardedPosePipeline(yolo_f, kpd_f, kp3d, DRYRUN_CAM_K, ecfg,
                                  mesh=smesh, device="cpu")(frames[:1])
        assert torch.isfinite(out["proposal_score"]).all()
        sp_msg = " spatial_eval=ok"
    return (f"dryrun_multichip({n}): kpd_loss={kpd_loss:.6f} "
            f"yolo_loss={yolo_loss:.6f}{tp_msg} multi_cand_eval=ok{sp_msg} "
            "ok")


def dryrun_multichip(n_devices: int) -> str:
    """A DP KPD step (resnet50, 4 keypoints, 64x32, adam), a DP YOLO step
    (the tiny cfg), a DP x TP KPD train step when n >= 4 and even, the
    sharded multi-candidate eval and, when n >= 2, the spatial eval at
    batch 1, over n CPU ranks under gloo (`parallel/launch`), in the
    order of the JAX `dryrun_multichip`.  Prints and returns its line."""
    from .parallel import launch
    line = launch.run_ranks(_dryrun_rank, int(n_devices), "cpu",
                            int(n_devices))
    print(line)
    return line
