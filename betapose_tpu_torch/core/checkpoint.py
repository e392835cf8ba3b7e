"""Checkpoint paths and the KPD checkpoint loader.

- YOLO: darknet `.weights`, read by `models/yolov3.load_darknet_weights`.
- KPD: the reference stores torch `state_dict` pickles
  (`train_KPD/src/train.py:192-197`); the port's FastPose keeps the
  reference module names, so a `.pkl`/`.pth` loads natively.
"""

from __future__ import annotations

import os

import torch

from betapose_tpu_torch.models import kpd as kpd_mod


def load_kpd_checkpoint(path, n_classes: int = 50, arch: str = "resnet101"):
    """A FastPose from a torch `.pkl`/`.pth` state_dict (optionally wrapped
    as {"state_dict": ...}).  Loaded with `weights_only=True`: tensors and
    containers only, no arbitrary pickled objects."""
    if os.path.splitext(path)[1] not in (".pkl", ".pth"):
        raise ValueError(f"KPD checkpoint {path}: the port reads torch "
                         ".pkl/.pth state_dicts")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return kpd_mod.from_state_dict(obj, n_classes, arch)


# Per-object KPD checkpoint names (reference
# KPD/src/main_fast_inference.py:29-36 hardcodes these .pkl names).
KPD_MODEL_NAMES = {
    1: "seq1_model", 2: "seq2_model", 4: "seq4_model", 5: "seq5_model",
    6: "seq6_model", 8: "seq8_model", 9: "seq9_model", 10: "seq10_model",
    11: "seq11_model", 12: "seq12_model", 13: "seq13_model",
    14: "seq14_model", 15: "seq15_model",
}


def default_kpd_path(obj_id: int, base: str = "./exp/final_model"):
    name = KPD_MODEL_NAMES.get(obj_id, f"seq{obj_id}_model")
    for ext in (".pkl", ".pth"):
        p = os.path.join(base, name + ext)
        if os.path.exists(p):
            return p
    return os.path.join(base, name + ".pkl")


def default_yolo_path(obj_id: int, base: str = "models/yolo"):
    """Reference DetectionLoader weight path (`dataloader.py:289`)."""
    return os.path.join(base, "{:02d}.weights".format(obj_id))
