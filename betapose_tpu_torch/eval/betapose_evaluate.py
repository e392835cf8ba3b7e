"""End-to-end LineMod 6D-pose evaluation CLI on the card.

Counterpart of `betapose_tpu/eval/betapose_evaluate.py` and of the
reference `betapose_evaluate.py`: the same flags plus `--device` (default
`cuda`), the same `Betapose-results.json`, the same final metric prints
(ADD accuracy / 2D-reprojection accuracy / mean IoU,
`betapose_evaluate.py:263-266`).

Usage:
  python -m betapose_tpu_torch.eval.betapose_evaluate \
      --indir <sixd>/test/01/rgb --outdir out/ --obj_id 1 \
      --sixd_base <sixd> [--yolo_weights w.weights] \
      [--kpd_weights m.pkl|m.npz] [--netType resnet101|resnet50|hgPRM] \
      [--device cuda|cpu]
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from betapose_tpu_torch.core import checkpoint as ckpt
from betapose_tpu_torch.core.config import Config, make_parser
from betapose_tpu_torch.core.device import resolve_device
from betapose_tpu_torch.core.profiling import RuntimeProfile
from betapose_tpu_torch.data import sixd as sixd_mod
from betapose_tpu_torch.data.loader import (FrameCache, list_images,
                                             make_loader)
from betapose_tpu_torch.eval import results as results_mod
from betapose_tpu_torch.eval.pipeline import PipelineConfig, PosePipeline
from betapose_tpu_torch.geometry import metrics
from betapose_tpu_torch.geometry.model3d import Model3D
from betapose_tpu_torch.models import hgprm as hgprm_mod
from betapose_tpu_torch.models import kpd as kpd_mod
from betapose_tpu_torch.models import yolov3 as yolo_mod
from betapose_tpu_torch.models.darknet_cfg import make_yolov3_cfg

TOTAL_KP_NUMBER = 50  # betapose_evaluate.py:36


class Benchmark:
    def __init__(self):
        self.cam = np.identity(3)
        self.models = {}
        self.kpmodels = {}


def load_sixd_models(base_path, obj_id, total_kp=TOTAL_KP_NUMBER):
    """Parity with `betapose_evaluate.py:53-84`: hardcoded LineMod camera,
    mesh + diameters from models_info.yml, keypoint model refined to 50."""
    print("Loading models and KP models...")
    bench = Benchmark()
    bench.scale_to_meters = 0.001
    bench.cam = sixd_mod.LINEMOD_CAM_K.copy()

    model_info = sixd_mod.load_yaml(
        os.path.join(base_path, "models", "models_info.yml"))
    for key, val in model_info.items():
        name = "{:02d}".format(int(key))
        bench.models[name] = Model3D()
        bench.models[name].diameter = val["diameter"]

    name = "obj_{:02d}".format(obj_id)
    bench.models["{:02d}".format(obj_id)].load(
        os.path.join(base_path, "models", name + ".ply"),
        scale=bench.scale_to_meters)
    print("Loading models finished!")

    kp = Model3D()
    kp.load(os.path.join(base_path, "kpmodels", name + ".ply"),
            scale=bench.scale_to_meters)
    kp.refine(total_kp)
    bench.kpmodels["{:02d}".format(obj_id)] = kp
    print("Load and refine KP models finished!")
    return bench


def build_pipeline(cfg: Config, args, kp_vertices, cam_K,
                   left_keypoints: int | None = None, device=None):
    """The networks (weights from disk, else a seeded random init in smoke
    mode), wrapped in a `PosePipeline` on `device` (None:
    cfg.runtime.device).  YOLO's and FastPose's batch norms are folded;
    PyraNet's (`--netType hgPRM`) are not, as in the JAX package: its
    pre-activation batch norms sit before a ReLU, where no conv can take
    them.

    The conv path runs bf16 on the card and float32 on the CPU: torch's CPU
    bf16 convolutions are slow, and their first call now and then returns
    NaN (torch 2.13, CPU build).  PyraNet runs float32 on both."""
    device = resolve_device(cfg.runtime.device if device is None else device)
    arch = cfg.model.net_type
    if arch not in ("resnet101", "resnet50", "hgPRM"):
        raise SystemExit(
            f"unsupported --netType {arch!r} for evaluation: the pipeline "
            "serves FastPose (resnet101, resnet50) and hgPRM")
    hg_kwargs = (dict(n_feats=cfg.model.n_feats, n_stack=cfg.model.n_stack,
                      n_residual=args.nResidual, base_width=args.baseWidth,
                      cardinality=args.cardinality)
                 if arch == "hgPRM" else {})

    yolo_cfg_text = (open(args.yolo_cfg).read() if args.yolo_cfg
                     else make_yolov3_cfg(num_classes=1,
                                          width=cfg.model.inp_dim,
                                          height=cfg.model.inp_dim))
    spec = yolo_mod.build_spec(yolo_cfg_text)
    reso = cfg.model.inp_dim

    yolo_weights = args.yolo_weights or ckpt.default_yolo_path(cfg.obj_id)
    if os.path.exists(yolo_weights):
        yolo, _ = yolo_mod.load_darknet_weights(spec, yolo_weights, reso)
        print("Loading YOLO weights from", yolo_weights)
    elif args.yolo_weights:
        # an explicit path that doesn't resolve is an error: a typo must not
        # give a plausible-looking random-weights run
        raise FileNotFoundError(
            f"--yolo_weights {args.yolo_weights} does not exist")
    else:
        print(f"WARNING: YOLO weights {yolo_weights} not found; "
              "using random init (smoke mode)")
        yolo = yolo_mod.Darknet(spec, reso, torch.Generator().manual_seed(0))

    kpd_weights = args.kpd_weights or ckpt.default_kpd_path(cfg.obj_id)
    if os.path.exists(kpd_weights):
        kpd = ckpt.load_kpd_checkpoint(kpd_weights, cfg.model.n_classes, arch,
                                       **hg_kwargs)
        print("Loading KPD weights from", kpd_weights)
    elif args.kpd_weights:
        raise FileNotFoundError(
            f"--kpd_weights {args.kpd_weights} does not exist")
    else:
        print(f"WARNING: KPD weights {kpd_weights} not found; "
              "using random init (smoke mode)")
        gen = torch.Generator().manual_seed(1)
        kpd = (hgprm_mod.PyraNet(cfg.model.n_classes, generator=gen,
                                 **hg_kwargs) if arch == "hgPRM"
               else kpd_mod.FastPose(cfg.model.n_classes, arch, gen))
    if arch != "hgPRM":
        kpd = kpd_mod.fold_bn(kpd)

    pcfg = PipelineConfig(
        reso=reso,
        inp_h=cfg.model.input_res_h, inp_w=cfg.model.input_res_w,
        out_h=cfg.model.output_res_h, out_w=cfg.model.output_res_w,
        n_kp=cfg.model.n_classes,
        confidence=cfg.detection.confidence,
        left_keypoints=TOTAL_KP_NUMBER,  # betapose_evaluate.py:138 passes 50
        preproc=args.preproc,
        det_capacity=cfg.detection.det_capacity,
        host_pose_nms=cfg.detection.host_pose_nms,
        nms_thresh=cfg.detection.nms_thresh,
        pnp_robust_rounds=cfg.detection.pnp_robust,
        pnp_score_power=cfg.detection.pnp_score_power,
        pnp_spread_power=cfg.detection.pnp_spread_power,
        pnp_depth_prior=cfg.detection.pnp_depth_prior,
        flip_tta=not cfg.model.fast_inference,
        net_type=arch,
        compute_dtype="bfloat16" if device.type == "cuda" else "float32")
    return PosePipeline(
        yolo_mod.fold_bn(yolo), kpd, kp_vertices, cam_K,
        pcfg, left_keypoints=left_keypoints, device=device)


def collect_results(pipeline, im_names, batch_size, profile=False,
                    host_loader="auto", frame_cache=None):
    """Run the pipeline over all frames; build the reference-format
    final_result list.  profile=True runs the three stages with a device
    synchronize after each and prints per-stage means (the reference's
    det/pose/post readout, `betapose_evaluate.py:132-136,181-186`).

    frame_cache: the path of a `FrameCache` (.npy) to serve the frames
    from instead of `host_loader`; it is built from `im_names` when it
    does not exist.  Returns (final_result, frames/s of the frame loop)."""
    if frame_cache is not None:
        n = len(im_names)
        batches = FrameCache(im_names, frame_cache).batches(batch_size)
        batch_sizes = [min(batch_size, n - s) for s in range(0, n, batch_size)]
    else:
        batches = make_loader(im_names, batch_size, mode=host_loader)
        batch_sizes = batches.batch_sizes
    final_result = []
    prof = RuntimeProfile()
    idx = 0
    t0 = time.time()
    outs = pipeline.run_batches(batches, prof if profile else None)
    for bi, out in enumerate(outs):
        for j in range(batch_sizes[bi]):
            im_name = os.path.basename(im_names[idx])
            idx += 1
            if not out["det_valid"][j]:
                final_result.append(results_mod.make_frame_result(
                    im_name, [], [], []))
                continue
            result = []
            if out["pose_valid"][j]:
                result.append({
                    "bbox": out["boxes"][j],
                    "keypoints": out["keypoints"][j],
                    "kp_score": out["kp_scores"][j][:, None],
                    "proposal_score": float(out["proposal_score"][j]),
                })
            cam_R = out["cam_R"][j] if result else []
            cam_t = out["cam_t"][j].reshape(3, 1) if result else []
            final_result.append(results_mod.make_frame_result(
                im_name, result, cam_R, cam_t))
    wall = time.time() - t0
    fps = len(im_names) / wall if wall > 0 else 0.0
    if profile:
        # per-batch means (the reference's are per frame at batch 1)
        print("det time: {dt:.4f} | pose time: {pt:.4f} | "
              "post processing: {pn:.4f}".format(
                  dt=prof.mean("dt"), pt=prof.mean("pt"),
                  pn=prof.mean("pn")))
        print(f"processed {len(im_names)} frames in {wall:.2f}s "
              f"({fps:.1f} fps) on {pipeline.device}")
    return final_result, fps


def evaluate_metrics(final_result, sixd_base, obj_id, model_vertices,
                     pixel_thresh=5.0, symmetric=False):
    """Metric loop parity (`betapose_evaluate.py:204-266`); symmetric=True
    grades with ADD-S (closest vertex)."""
    print("Loading ground truth benchmark dataset...")
    bench_info = sixd_mod.load_sixd(sixd_base, seq=obj_id, nr_frames=0)
    diameter = bench_info.diameter[obj_id]
    frames = bench_info.frames
    add_fn = metrics.adds_err if symmetric else metrics.add_err

    add_errs, adds, proj_errs, ious = [], [], [], []
    for f in final_result:
        imgname = int(os.path.splitext(f["imgname"])[0])
        gt_obj_id, gt_pose, gt_bbox = frames[imgname].gt[0]
        if gt_obj_id != obj_id:
            continue
        gt_bbox = list(gt_bbox)
        gt_bbox[2] += gt_bbox[0]
        gt_bbox[3] += gt_bbox[1]
        if len(f["result"]) < 1:
            continue
        pred_bbox = np.asarray(f["result"][0]["bbox"]).tolist()
        iou_frame = metrics.iou(gt_bbox, pred_bbox)
        ious.append(iou_frame)
        pred_pose = np.eye(4)
        pred_pose[:3, :3] = np.asarray(f["cam_R"])
        pred_pose[:3, 3] = np.asarray(f["cam_t"]).reshape(3)
        if iou_frame >= 0.5:
            add = add_fn(gt_pose, pred_pose, model_vertices) * 1000
            add_errs.append(add)
            adds.append(add < diameter / 10)
            proj_errs.append(metrics.projection_error_2d(
                gt_pose, pred_pose, model_vertices, bench_info.cam))

    stats = {
        "mean_add_err": float(np.mean(add_errs)) if add_errs else float("nan"),
        "mean_add": float(np.mean(adds)) if adds else 0.0,
        "mean_2d_acc": float(np.mean(np.array(proj_errs) < pixel_thresh))
        if proj_errs else 0.0,
        "mean_iou": float(np.mean(np.array(ious) > 0.5)) if ious else 0.0,
        "add_metric": "ADD-S" if symmetric else "ADD",
    }
    label = "add(-S)" if symmetric else "add"
    print("Mean %s accuracy for seq %02d is: %.3f"
          % (label, obj_id, stats["mean_add"]))
    print("2d reprojection accuracy for seq %02d is: %.3f"
          % (obj_id, stats["mean_2d_acc"]))
    print("Mean IoU for seq %02d is: %.3f" % (obj_id, stats["mean_iou"]))
    return stats


def run_eval(argv=None, frame_cache=None, report=None, pipeline=None):
    """The CLI's evaluation on the parsed `argv`: frames from `--indir` or
    `--list` through `--host_loader` (or from the `FrameCache` at
    `frame_cache`), the results JSON in `--outdir`, the metric prints.
    Returns the stats dict with the frames/s of the frame loop, host
    decode included.  report: a dict that receives the pipeline, the
    image list and the final_result list.  pipeline: one built by an
    earlier run on the same model flags (from its report), so that
    several feeds or image sets are evaluated on networks loaded once."""
    args = make_parser("Betapose evaluation (PyTorch)").parse_args(argv)
    cfg = Config.from_args(args)

    print("Betapose begin running now.")
    obj_id = cfg.obj_id
    print("Test seq", obj_id)
    bench = load_sixd_models(args.sixd_base, obj_id)
    key = "{:02d}".format(obj_id)
    kp_vertices = bench.kpmodels[key].vertices
    model_vertices = bench.models[key].vertices

    im_names = list_images(cfg.runtime.input_path, cfg.runtime.input_list)
    os.makedirs(cfg.runtime.output_path, exist_ok=True)

    if pipeline is None:
        pipeline = build_pipeline(cfg, args, kp_vertices, bench.cam)
    final_result, fps = collect_results(
        pipeline, im_names, max(cfg.detection.det_batch, 1),
        profile=cfg.runtime.profile, host_loader=cfg.runtime.host_loader,
        frame_cache=frame_cache)
    print("===========================> Finish Model Running.")
    if report is not None:
        report.update(pipeline=pipeline, im_names=im_names,
                      final_result=final_result)

    results_mod.write_json(final_result, cfg.runtime.output_path,
                           form=cfg.runtime.format)
    stats = evaluate_metrics(final_result, args.sixd_base, obj_id,
                             model_vertices,
                             symmetric=obj_id in cfg.sym_objects)
    stats["fps"] = fps
    return stats


def main(argv=None):
    return run_eval(argv)


if __name__ == "__main__":
    main()
