"""SIXD / LineMod benchmark loading.

Parity with the reference `utils/sixd.py:60-111`: camera.yml intrinsics,
models_info.yml diameters (1-indexed list with a 10000.0 sentinel at index 0),
per-sequence info.yml / gt.yml parsed into per-frame 4x4 poses (rotation
model-to-camera, translation scaled by 0.001 into meters) and object bboxes.
"""

from __future__ import annotations

import os
import numpy as np
import yaml


def load_yaml(path):
    with open(path, "r") as f:
        return yaml.safe_load(f)


class Frame:
    def __init__(self):
        self.nr = None
        self.path = None
        self.cam = np.identity(3)
        self.gt = []  # list of (obj_id, 4x4 pose, [xmin, ymin, w, h])


class Benchmark:
    def __init__(self):
        self.cam = np.identity(3)
        self.models = {}
        self.frames = []
        self.diameter = []
        self.scale_to_meters = 0.001


def load_info(path):
    info = load_yaml(path)
    for eid in info:
        e = info[eid]
        if "cam_K" in e:
            e["cam_K"] = np.array(e["cam_K"]).reshape(3, 3)
        if "cam_R_w2c" in e:
            e["cam_R_w2c"] = np.array(e["cam_R_w2c"]).reshape(3, 3)
        if "cam_t_w2c" in e:
            e["cam_t_w2c"] = np.array(e["cam_t_w2c"]).reshape(3, 1)
    return info


def load_gt(path):
    gts = load_yaml(path)
    for _, gts_im in gts.items():
        for gt in gts_im:
            if "cam_R_m2c" in gt:
                gt["cam_R_m2c"] = np.array(gt["cam_R_m2c"]).reshape(3, 3)
            if "cam_t_m2c" in gt:
                gt["cam_t_m2c"] = np.array(gt["cam_t_m2c"]).reshape(3, 1)
    return gts


def load_sixd(base_path, seq=None, nr_frames=0, load_mesh=True) -> Benchmark:
    bench = Benchmark()

    cam_path = os.path.join(base_path, "camera.yml")
    if os.path.exists(cam_path):
        cam_info = load_yaml(cam_path)
        bench.cam[0, 0] = cam_info["fx"]
        bench.cam[0, 2] = cam_info["cx"]
        bench.cam[1, 1] = cam_info["fy"]
        bench.cam[1, 2] = cam_info["cy"]

    model_info = load_yaml(os.path.join(base_path, "models", "models_info.yml"))
    bench.diameter.append(10000.0)  # 1-indexed objects (utils/sixd.py:74)
    for _, val in sorted(model_info.items()):
        bench.diameter.append(val["diameter"])

    if seq is None:
        return bench

    path = os.path.join(base_path, "test", "{:02d}".format(seq))
    info = load_info(os.path.join(path, "info.yml"))
    gts = load_gt(os.path.join(path, "gt.yml"))

    nr_frames = nr_frames if nr_frames > 0 else len(info)
    for i in range(nr_frames):
        fr = Frame()
        fr.nr = i
        fr.path = os.path.join(path, "rgb", "{:04d}.png".format(i))
        for gt in gts[i]:
            pose = np.identity(4)
            pose[:3, :3] = gt["cam_R_m2c"]
            pose[:3, 3] = np.squeeze(gt["cam_t_m2c"]) * bench.scale_to_meters
            fr.gt.append((gt["obj_id"], pose, list(gt["obj_bb"])))
        fr.cam = info[i]["cam_K"]
        bench.frames.append(fr)

    return bench


# Hardcoded LineMod intrinsics used by the eval entry point
# (betapose_evaluate.py:59).
LINEMOD_CAM_K = np.array(
    [[572.4114, 0.0, 325.2611],
     [0.0, 573.57043, 242.04899],
     [0.0, 0.0, 1.0]])
