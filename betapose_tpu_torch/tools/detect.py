"""Standalone object-detection demo CLI.

Counterpart of `betapose_tpu/tools/detect.py` and of the reference's
`yolo/detect.py` (COCO-80 image-directory demo): run YOLOv3 on a directory
of images, draw boxes, write `det_<name>` outputs, on the card unless
`--device cpu`.  It runs on `tools/darknet_cli`'s detection helpers.

Usage:
  python -m betapose_tpu_torch.tools.detect --images imgs/ --det det/ \
      [--cfg yolov3.cfg] [--weights yolov3.weights] [--names coco.names] \
      [--confidence 0.5] [--nms_thresh 0.4] [--reso 416] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="Betapose detection demo")
    p.add_argument("--images", default="imgs", help="image file/directory")
    p.add_argument("--det", default="det", help="output directory")
    p.add_argument("--bs", type=int, default=8)
    p.add_argument("--confidence", type=float, default=0.5)
    p.add_argument("--nms_thresh", type=float, default=0.4)
    p.add_argument("--cfg", default=None, help="darknet cfg")
    p.add_argument("--weights", default=None, help="darknet .weights")
    p.add_argument("--names", default=None, help="class names file")
    p.add_argument("--num_classes", type=int, default=80)
    p.add_argument("--reso", default="416")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda | cpu); cuda raises when no "
                        "CUDA device is present")
    args = p.parse_args(argv)

    import cv2
    import torch
    from ..core.device import resolve_device
    from ..data.loader import imread_rgb
    from ..models import yolov3 as yolo_mod
    from ..models.darknet_cfg import make_yolov3_cfg
    from .darknet_cli import _detect_images

    dev = resolve_device(args.device)
    reso = int(args.reso)
    cfg_text = (open(args.cfg).read() if args.cfg
                else make_yolov3_cfg(num_classes=args.num_classes,
                                     width=reso, height=reso))
    spec = yolo_mod.build_spec(cfg_text)
    if args.weights and os.path.exists(args.weights):
        model, _ = yolo_mod.load_darknet_weights(spec, args.weights, reso)
    else:
        model = yolo_mod.Darknet(spec, reso, torch.Generator().manual_seed(0))
        print("WARNING: no weights provided; random init (demo smoke mode)")
    model = yolo_mod.fold_bn(model).to(dev)
    names = ([ln.strip() for ln in open(args.names)] if args.names
             else [str(i) for i in range(args.num_classes)])

    if os.path.isdir(args.images):
        paths = [os.path.join(args.images, f)
                 for f in sorted(os.listdir(args.images))]
    else:
        paths = [args.images]
    os.makedirs(args.det, exist_ok=True)

    dets = _detect_images(model, reso, paths, args.confidence,
                          args.nms_thresh, batch=args.bs)
    for path, det in zip(paths, dets):
        img = imread_rgb(path)[:, :, ::-1].copy()  # draw in BGR
        for d in det:
            x1, y1, x2, y2, sc, cid = d
            label = names[int(cid)] if int(cid) < len(names) else str(int(cid))
            cv2.rectangle(img, (int(x1), int(y1)), (int(x2), int(y2)),
                          (60, 180, 255), 2)
            cv2.putText(img, f"{label} {sc:.2f}", (int(x1), int(y1) - 4),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (60, 180, 255), 1)
            print(f"{os.path.basename(path)}: {label} {sc:.3f} "
                  f"[{x1:.0f},{y1:.0f},{x2:.0f},{y2:.0f}]")
        cv2.imwrite(os.path.join(
            args.det, "det_" + os.path.basename(path)), img)
    print(f"detections written to {args.det}/")
    return dets


if __name__ == "__main__":
    main()
