"""Box post-processing: xywh->xyxy, IoU, the reference's best-box selection,
the capacity-N candidate selection and the box rescales back to frame
pixels.

Counterpart of `betapose_tpu/ops/boxes.py` (reference `yolo/util.py:104-224`):
objectness threshold mask, class filter, and one best box per frame by
masked objectness (the reference hard-codes NMS off, `yolo/util.py:181`,
and keeps the argmax, `yolo/util.py:210-211`).  The multi-candidate path
(`det_capacity > 1`) keeps up to N boxes per frame with `top_boxes`: a
top-`prefilter` cut by masked objectness, then greedy `nms`, both batched
over frames with fixed shapes and no host sync.

Order among equal scores follows `jax.lax.top_k` and the stable
`jnp.argsort`: the lower index first.  `torch.topk` does not promise that,
so both selections use a stable descending `torch.sort`.
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


def _sort_desc(scores):
    """(values, indices) sorted descending along the last axis; equal
    values keep their index order, as `jax.lax.top_k` and the stable
    `jnp.argsort(-scores)` give."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)


def nms(boxes, scores, iou_thresh: float, max_out: int):
    """Greedy NMS over each frame's rows, fixed shapes (the reference's dead
    `nms=True` branch, `yolo/util.py:183-199`, and darknet's `do_nms_sort`).

    boxes [B,n,4] xyxy, scores [B,n].  Rows are visited in descending score
    order; a visited row that is still alive suppresses every later row with
    IoU >= iou_thresh.  Returns (keep_idx [B,max_out] int64 row indices in
    visiting order, padded with 0; keep_mask [B,max_out]).

    The IoU matrix is taken once; each of the n trips only updates the
    alive mask, on the device, with no host sync."""
    b, n = scores.shape
    order = _sort_desc(scores)[1]
    boxes_sorted = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    ious = bbox_iou(boxes_sorted[:, :, None], boxes_sorted[:, None, :])
    later = torch.ones(n, n, dtype=torch.bool,
                       device=boxes.device).triu(diagonal=1)
    suppress = (ious >= iou_thresh) & later                   # [B,n,n]
    alive = torch.ones(b, n, dtype=torch.bool, device=boxes.device)
    for i in range(n):
        alive = alive & ~(alive[:, i:i + 1] & suppress[:, i])
    # the first max_out survivors in visiting order
    rank = alive.long().cumsum(dim=1) - 1
    slot = torch.where(alive & (rank < max_out), rank, max_out)
    keep_idx = torch.zeros(b, max_out + 1, dtype=torch.long,
                           device=boxes.device)
    keep_idx.scatter_(1, slot, order)
    keep_mask = torch.zeros(b, max_out + 1, dtype=torch.bool,
                            device=boxes.device)
    keep_mask.scatter_(1, slot, alive)
    return keep_idx[:, :max_out], keep_mask[:, :max_out]


def top_boxes(predictions, confidence: float, target_class: int = 0,
              capacity: int = 4, nms_thresh: float = 0.4,
              prefilter: int = 64):
    """Capacity-N extension of `best_box` for crowded/occlusion scenes: up
    to `capacity` target-class boxes per frame by objectness after greedy
    NMS (the reference's `nms=True` branch, `yolo/util.py:183-199`).

    The candidates are first cut to the top `prefilter` rows by masked
    objectness (rows failing the mask score -1 and can fill slots, marked
    invalid), then `nms` picks up to `capacity`.

    predictions: [B, nBoxes, 5+nC].  Returns a dict: boxes [B,N,4] xyxy
    (network-input pixels), obj_score [B,N], cls_score [B,N], valid [B,N]
    (False for padded slots and below-threshold rows)."""
    m = min(prefilter, predictions.shape[1])
    obj = predictions[..., 4]
    cls_score = predictions[..., 5:].amax(dim=-1)
    cls_best = predictions[..., 5:].argmax(dim=-1)
    mask = (obj > confidence) & (cls_best == target_class)
    masked_obj = torch.where(mask, obj, torch.full_like(obj, -1.0))
    top_sc, top_i = _sort_desc(masked_obj)
    top_sc, top_i = top_sc[:, :m], top_i[:, :m]
    boxes_m = xywh_to_xyxy(predictions[..., :4].gather(
        1, top_i[..., None].expand(-1, -1, 4)))
    keep_idx, keep_mask = nms(boxes_m, top_sc, nms_thresh, capacity)
    rows = top_i.gather(1, keep_idx)                        # [B,N]
    return {
        "boxes": boxes_m.gather(1, keep_idx[..., None].expand(-1, -1, 4)),
        "obj_score": obj.gather(1, rows),
        "cls_score": cls_score.gather(1, rows),
        "valid": keep_mask & mask.gather(1, rows),
    }
