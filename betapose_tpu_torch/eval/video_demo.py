"""Video / webcam 6D-pose demo CLI on the card.

Counterpart of `betapose_tpu/eval/video_demo.py` (the reference's video
paths, `video_demo.py`, `cam_demo.py`, `--video/--webcam/--save_video`):
run the port's pose pipeline on a video file or a webcam stream, with an
optional overlay video.  The same flags as the evaluation CLI, `--device`
included; any `--det_capacity` is served.

Usage:
  python -m betapose_tpu_torch.eval.video_demo --video in.mp4 --obj_id 1 \
      --sixd_base <sixd> --outdir out/ --save_video [--device cuda|cpu]
  python -m betapose_tpu_torch.eval.video_demo --webcam 0 ...
"""

from __future__ import annotations

import itertools
import os

from betapose_tpu_torch.core.config import Config, make_parser
from betapose_tpu_torch.data.video import (VideoLoader, VideoWriter,
                                           WebcamLoader, draw_pose_overlay)
from betapose_tpu_torch.eval.betapose_evaluate import (build_pipeline,
                                                       load_sixd_models)
from betapose_tpu_torch.eval.pipeline import to_numpy

KEEP = ("boxes", "pose_valid", "cam_R", "cam_t")


def main(argv=None):
    args = make_parser("Betapose video demo (PyTorch)").parse_args(argv)
    cfg = Config.from_args(args)

    bench = load_sixd_models(args.sixd_base, cfg.obj_id)
    kp_vertices = bench.kpmodels["{:02d}".format(cfg.obj_id)].vertices
    pipeline = build_pipeline(cfg, args, kp_vertices, bench.cam)
    os.makedirs(cfg.runtime.output_path, exist_ok=True)

    writer = None
    results = []
    if cfg.runtime.video:
        loader = VideoLoader(cfg.runtime.video,
                             batch_size=max(cfg.detection.det_batch, 1))
        if cfg.runtime.save_video:
            _, fps, size = loader.videoinfo()
            writer = VideoWriter(
                os.path.join(cfg.runtime.output_path, "render.avi"),
                fps or 25, size)
        for frames in loader:
            out = to_numpy(pipeline(frames))
            # the padded tail of the last batch gives no results
            for j in range(loader.n_real):
                results.append({k: out[k][j] for k in KEEP})
                if writer is not None:
                    writer.write_rgb(draw_pose_overlay(
                        frames[j],
                        out["boxes"][j] if out["det_valid"][j] else None,
                        out["keypoints"][j] if out["pose_valid"][j] else None,
                        out["kp_scores"][j]))
        if writer is not None:
            writer.release()
    else:
        cam = WebcamLoader(cfg.runtime.webcam)
        try:
            for _ in itertools.count():
                frame = cam.read()
                out = to_numpy(pipeline(frame[None]))
                results.append({k: out[k][0] for k in KEEP})
                print("pose_valid:", bool(out["pose_valid"][0]),
                      "t:", out["cam_t"][0])
        except KeyboardInterrupt:
            cam.stop()
    print(f"processed {len(results)} frames")
    return results
