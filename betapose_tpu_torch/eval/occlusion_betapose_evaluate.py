"""Occlusion-LineMod 6D-pose evaluation CLI on the card.

Counterpart of `betapose_tpu/eval/occlusion_betapose_evaluate.py` and of
the reference `occlusion_betapose_evaluate.py`, with the same flags plus
`--device` (default `cuda`): same pipeline as the
LineMod eval but (a) ground truth comes from the seq-02 scene whose frames
carry ALL objects' GT (`occlusion_betapose_evaluate.py:204,218`), (b)
`--left_keypoints` controls how many highest-scoring keypoints feed PnP
(`:139` -> DataWriter pruning), (c) the 2D-projection threshold is 20 px
(`:255`).  The multi-candidate path serves the occluded scenes:
`--det_capacity 4 --pnp_robust 2 --pnp_score_power 4` is the JAX package's
occlusion recipe (`betapose_tpu/tools/occl_multiobj.py`), and
`--host_pose_nms` clusters the candidates on the host.

Usage:
  python -m betapose_tpu_torch.eval.occlusion_betapose_evaluate \
      --indir <occl>/test/02/rgb --outdir out/ --obj_id 1 \
      --left_keypoints 10 --sixd_base <occl> [--det_capacity 4] \
      [--device cuda|cpu]
"""

from __future__ import annotations

import os

import numpy as np

from betapose_tpu_torch.core.config import Config, make_parser
from betapose_tpu_torch.data import sixd as sixd_mod
from betapose_tpu_torch.data.loader import list_images
from betapose_tpu_torch.eval import results as results_mod
from betapose_tpu_torch.eval.betapose_evaluate import (
    build_pipeline, collect_results, load_sixd_models)
from betapose_tpu_torch.geometry import metrics

OCCLUSION_SEQ = 2       # occlusion GT lives in scene 02
PIXEL_THRESH = 20.0     # occlusion_betapose_evaluate.py:255


def evaluate_occlusion_metrics(final_result, sixd_base, obj_id,
                               model_vertices, left_keypoints,
                               pixel_thresh=PIXEL_THRESH, symmetric=False,
                               occlusion_seq=OCCLUSION_SEQ):
    """Metric loop parity (`occlusion_betapose_evaluate.py:195-273`):
    iterate every GT object per frame, keep entries of the chosen object.

    symmetric=True grades with ADD-S (reference `utils/metrics.py:23-33`,
    carried commented out there) — eggbox and glue ARE in the Occlusion-
    LineMod object set, so this loop needs the switch as much as the
    clean-LineMod one."""
    print("Loading ground truth of OCCLUSION dataset...")
    bench_info = sixd_mod.load_sixd(sixd_base, seq=occlusion_seq,
                                    nr_frames=0)
    diameter = bench_info.diameter[obj_id]
    frames = bench_info.frames
    add_fn = metrics.adds_err if symmetric else metrics.add_err

    add_errs, adds, proj_errs, ious = [], [], [], []
    for f in final_result:
        imgname = int(os.path.splitext(f["imgname"])[0])
        gt_frame = frames[imgname]
        for gt_obj_id, gt_pose, gt_bb in gt_frame.gt:
            if gt_obj_id != obj_id:
                continue
            gt_bbox = list(gt_bb)
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
    print("Mean add%s accuracy for seq %02d is: %.3f"
          % ("(-S)" if symmetric else "", obj_id, stats["mean_add"]))
    print("2d reprojection accuracy with leftkeypoints %d for seq %02d is: "
          "%.3f" % (left_keypoints, obj_id, stats["mean_2d_acc"]))
    print("Mean IoU for seq %02d is: %.3f" % (obj_id, stats["mean_iou"]))
    return stats


def main(argv=None):
    parser = make_parser("Betapose occlusion evaluation (PyTorch)")
    args = parser.parse_args(argv)
    cfg = Config.from_args(args)

    print("Betapose begin running now.")
    obj_id = cfg.obj_id
    print("Test object", obj_id, "Left KP for PnP: ", cfg.left_keypoints)
    sixd_base = args.sixd_base
    bench = load_sixd_models(sixd_base, obj_id)
    kp_vertices = bench.kpmodels["{:02d}".format(obj_id)].vertices
    model_vertices = bench.models["{:02d}".format(obj_id)].vertices

    im_names = list_images(cfg.runtime.input_path, cfg.runtime.input_list)
    os.makedirs(cfg.runtime.output_path, exist_ok=True)

    # occlusion path prunes to left_keypoints before PnP (dataloader.py:718)
    pipeline = build_pipeline(cfg, args, kp_vertices, bench.cam,
                              left_keypoints=cfg.left_keypoints)

    final_result, fps = collect_results(
        pipeline, im_names, max(cfg.detection.det_batch, 1),
        profile=cfg.runtime.profile, host_loader=cfg.runtime.host_loader)
    print("===========================> Finish Model Running.")
    results_mod.write_json(final_result, cfg.runtime.output_path,
                           form=cfg.runtime.format)
    stats = evaluate_occlusion_metrics(
        final_result, sixd_base, obj_id, model_vertices, cfg.left_keypoints,
        symmetric=obj_id in cfg.sym_objects)
    stats["fps"] = fps
    return stats


if __name__ == "__main__":
    main()
