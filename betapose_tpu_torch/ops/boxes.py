"""Box post-processing: xywh->xyxy, IoU, the reference's best-box selection
and the box rescales back to frame pixels.

Counterpart of `betapose_tpu/ops/boxes.py` (reference `yolo/util.py:104-224`):
objectness threshold mask, class filter, and one best box per frame by
masked objectness (the reference hard-codes NMS off, `yolo/util.py:181`,
and keeps the argmax, `yolo/util.py:210-211`).  The capacity-N `top_boxes`
and greedy `nms` belong to the multi-candidate path (ROADMAP slice 2).
"""

from __future__ import annotations

import numpy as np
import torch


def xywh_to_xyxy(boxes):
    """(cx, cy, w, h) -> (x1, y1, x2, y2) (`yolo/util.py:126-131`)."""
    cx, cy, w, h = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def bbox_iou(box1, box2):
    """IoU with the reference's +1 convention (`yolo/bbox.py:51-77`);
    xyxy boxes (..., 4), broadcastable."""
    x1 = torch.maximum(box1[..., 0], box2[..., 0])
    y1 = torch.maximum(box1[..., 1], box2[..., 1])
    x2 = torch.minimum(box1[..., 2], box2[..., 2])
    y2 = torch.minimum(box1[..., 3], box2[..., 3])
    inter = (x2 - x1 + 1).clamp_min(0) * (y2 - y1 + 1).clamp_min(0)
    a1 = (box1[..., 2] - box1[..., 0] + 1) * (box1[..., 3] - box1[..., 1] + 1)
    a2 = (box2[..., 2] - box2[..., 0] + 1) * (box2[..., 3] - box2[..., 1] + 1)
    return inter / (a1 + a2 - inter)


def best_box(predictions, confidence: float, target_class: int = 0):
    """Fixed-shape equivalent of write_results' keep-single-best-box path.

    predictions: [B, nBoxes, 5+nC] decoded YOLO output.  Returns a dict:
      boxes [B,4] xyxy (network-input pixels), obj_score [B], cls_score [B],
      valid [B] (some box passed the threshold with argmax class ==
      target_class).
    The selection is the FIRST row of maximal masked objectness, as
    jnp.argmax picks; torch.argmax returns the first maximal index too."""
    obj = predictions[..., 4]
    cls_score = predictions[..., 5:].amax(dim=-1)
    cls_best = predictions[..., 5:].argmax(dim=-1)
    mask = (obj > confidence) & (cls_best == target_class)
    masked_obj = torch.where(mask, obj, torch.full_like(obj, -1.0))
    sel = masked_obj.argmax(dim=-1)                        # [B]
    best = predictions.gather(
        1, sel[:, None, None].expand(-1, 1, predictions.shape[-1]))[:, 0]
    return {
        "boxes": xywh_to_xyxy(best[..., :4]),
        "obj_score": obj.gather(1, sel[:, None])[:, 0],
        "cls_score": cls_score.gather(1, sel[:, None])[:, 0],
        "valid": mask.any(dim=-1),
    }


def rescale_boxes(boxes, orig_w, orig_h, reso: int):
    """Reference DetectionLoader box rescale (`dataloader.py:354-363`):
    multiply by orig/reso per axis (the reference letterboxes but rescales
    as if stretch-resized; 'stretch' preprocessing makes that consistent).
    boxes [B,4] xyxy; orig_w / orig_h scalars."""
    w_ratio = orig_w / reso
    h_ratio = orig_h / reso
    return torch.stack([
        boxes[..., 0] * w_ratio, boxes[..., 1] * h_ratio,
        boxes[..., 2] * w_ratio, boxes[..., 3] * h_ratio], dim=-1)


def unletterbox_boxes(boxes, orig_w, orig_h, reso: int):
    """Geometrically correct inverse of `letterbox` for boxes; orig_w /
    orig_h scalars.  The geometry is computed in float32, as the JAX
    package computes it."""
    scale = np.float32(min(reso / orig_w, reso / orig_h))
    new_w = np.floor(np.float32(orig_w) * scale)
    new_h = np.floor(np.float32(orig_h) * scale)
    off_x = float((np.float32(reso) - new_w) // 2)
    off_y = float((np.float32(reso) - new_h) // 2)
    scale = float(scale)
    return torch.stack([
        (boxes[..., 0] - off_x) / scale, (boxes[..., 1] - off_y) / scale,
        (boxes[..., 2] - off_x) / scale, (boxes[..., 3] - off_y) / scale],
        dim=-1)
