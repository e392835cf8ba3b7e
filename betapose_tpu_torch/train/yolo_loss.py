"""YOLOv3 training loss: darknet's `forward_yolo_layer` truth assignment
(`train_YOLO/src/yolo_layer.c:166-281`), vectorized.

Counterpart of `betapose_tpu/train/yolo_loss.py` (`head_loss`,
`yolo_loss`, `_canonical_anchor_order`), with the same semantics:

- per anchor and cell, objectness is pushed to 0 (BCE) unless the
  predicted box's best IoU over the frame's GT boxes exceeds the head's
  ignore_thresh;
- per GT box, the best of all 9 anchors by shape-only IoU; if it is one of
  this head's, the cell (floor(x*gw), floor(y*gh)) gets box regression on
  the logistic x, y (BCE) and the log-space w, h (0.5 * squared error),
  scaled by (2 - w*h), objectness target 1, and one-hot class BCE;
- collisions (several GTs on one cell and anchor) follow darknet's
  sequential loop: the last writer wins box and objectness, and the class
  target is the union of the one-hots; with focal_loss the first writer
  writes the focal-weighted vector and later ones flip their own entry;
- metrics per head: coord, obj, cls, noobj, count, avg_iou.

GT boxes come padded: truths [B, T, 5] = (x, y, w, h, class), normalized,
x == 0 marking padding; a class >= num_classes is skipped.  Raw heads are
NHWC [B, gh, gw, nA*(5+nC)], as `Darknet.forward(decode=False)` gives
them; the head math runs in float32.

Where torch differs from jnp: an out-of-range class index is clamped
before `gather` (jnp's `take_along_axis(mode="clip")`; torch's gather
raises), and one-hot rows are built by comparison, so a class outside
[0, nC) gives an all-zero row as `jax.nn.one_hot` does.
"""

from __future__ import annotations

import numpy as np
import torch


def _iou_xywh(b1, b2):
    """IoU of (x, y, w, h) centre boxes; broadcastable."""
    l1, r1 = b1[..., 0] - b1[..., 2] / 2, b1[..., 0] + b1[..., 2] / 2
    t1, d1 = b1[..., 1] - b1[..., 3] / 2, b1[..., 1] + b1[..., 3] / 2
    l2, r2 = b2[..., 0] - b2[..., 2] / 2, b2[..., 0] + b2[..., 2] / 2
    t2, d2 = b2[..., 1] - b2[..., 3] / 2, b2[..., 1] + b2[..., 3] / 2
    iw = (torch.minimum(r1, r2) - torch.maximum(l1, l2)).clamp_min(0)
    ih = (torch.minimum(d1, d2) - torch.maximum(t1, t2)).clamp_min(0)
    inter = iw * ih
    union = b1[..., 2] * b1[..., 3] + b2[..., 2] * b2[..., 3] - inter
    return inter / union.clamp_min(1e-12)


def _bce_from_logits(z, target):
    """Elementwise BCE with logits, in the JAX package's stable form, with
    jnp's gradients at z = 0: `jnp.maximum` splits its gradient there, as
    `torch.maximum` does, and `jnp.abs` takes slope 1, where `torch.abs`
    takes 0 (so the gradient there is -target, as in the JAX package)."""
    abs_z = torch.where(z >= 0, z, -z)
    return (torch.maximum(z, torch.zeros_like(z)) - z * target
            + torch.log1p(torch.exp(-abs_z)))


def _const(values, dtype, device):
    """A small constant on `device` without a host sync: the copy from
    pageable memory is staged at once and runs in stream order."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)


def _one_hot(cls, nc):
    """[..., nc] float one-hot of integer `cls`; all zero outside [0, nc)."""
    return (cls[..., None] == torch.arange(nc, device=cls.device)).float()


def head_loss(raw, anchors, all_anchors, num_classes, net_w, net_h,
              truths, ignore_thresh=0.7, focal=False):
    """Loss of one yolo head: (scalar loss, metrics dict of scalars).

    raw: [B, gh, gw, nA*(5+nC)] pre-activation head output (NHWC).
    anchors: this head's (w, h) anchor pixel sizes; all_anchors: all 9.
    truths: [B, T, 5] normalized (x, y, w, h, cls), x == 0 padding.
    focal: darknet's focal class deltas (`delta_yolo_class`,
    yolo_layer.c:121-138): alpha 0.5, pt = p_target + 1e-15, every class
    entry's plain delta times alpha * -(1-pt)(2 pt ln(pt) + pt - 1), the
    multiplier held constant (darknet never differentiates through it)."""
    b, gh, gw, _ = raw.shape
    na = len(anchors)
    nc = num_classes
    dev = raw.device
    x = raw.reshape(b, gh, gw, na, 5 + nc).permute(0, 3, 1, 2, 4)
    # [B, nA, gh, gw, 5+nc]
    tx_z, ty_z = x[..., 0], x[..., 1]
    tw_z, th_z = x[..., 2], x[..., 3]
    obj_z = x[..., 4]
    cls_z = x[..., 5:]

    grid_x = torch.arange(gw, dtype=torch.float32, device=dev)
    grid_y = torch.arange(gh, dtype=torch.float32, device=dev)[:, None]
    anc = _const(anchors, torch.float32, dev)
    aw = anc[:, 0][None, :, None, None]
    ah = anc[:, 1][None, :, None, None]

    # decoded predictions in normalized coords (get_yolo_box); the exp
    # arguments are clipped: these feed only the ignore mask and avg_iou
    with torch.no_grad():
        px = (torch.sigmoid(tx_z) + grid_x) / gw
        py = (torch.sigmoid(ty_z) + grid_y) / gh
        pw = torch.exp(tw_z.clamp(-12.0, 12.0)) * aw / net_w
        ph = torch.exp(th_z.clamp(-12.0, 12.0)) * ah / net_h
        pred = torch.stack([px, py, pw, ph], dim=-1)   # [B,nA,gh,gw,4]

    # class_id >= classes is skipped in both truth loops (yolo_layer.c:
    # 204-207, 238)
    gt_valid = (truths[..., 0] != 0) & (truths[..., 4] < nc)   # [B,T]
    gt_boxes = truths[..., :4]
    gt_cls = truths[..., 4].long()          # truncates, as astype(int32)

    # rule 1: background objectness with the ignore mask
    with torch.no_grad():
        ious = _iou_xywh(pred[..., None, :],
                         gt_boxes[:, None, None, None, :, :])
        ious = torch.where(gt_valid[:, None, None, None, :], ious, 0.0)
        best_iou = ious.max(dim=-1).values                    # [B,nA,gh,gw]
    obj_weight = torch.where(best_iou > ignore_thresh, 0.0, 1.0)

    # rule 2: the best of all anchors by shape, per GT
    all_anc = _const(all_anchors, torch.float32, dev)
    anc_shapes = torch.cat([torch.zeros_like(all_anc), all_anc / _const(
        [net_w, net_h], torch.float32, dev)], dim=1)
    gt_shift = torch.cat([torch.zeros_like(gt_boxes[..., :2]),
                          gt_boxes[..., 2:]], dim=-1)
    shape_iou = _iou_xywh(gt_shift[:, :, None, :],
                          anc_shapes[None, None, :, :])        # [B,T,9]
    best_n = torch.argmax(shape_iou, dim=-1)   # first maximum, as jnp's

    # global anchor index -> this head's anchor index, or -1
    all_list = [tuple(a) for a in all_anchors]
    local = [-1] * len(all_list)
    for li, a in enumerate(anchors):
        local[all_list.index(tuple(a))] = li
    mask_n = _const(local, torch.long, dev)[best_n]
    assign = gt_valid & (mask_n >= 0)

    ci = (gt_boxes[..., 0] * gw).long().clamp(0, gw - 1)
    cj = (gt_boxes[..., 1] * gh).long().clamp(0, gh - 1)
    an = mask_n.clamp(0, na - 1)

    # regression targets (delta_yolo_box, yolo_layer.c:94-109)
    t_x = gt_boxes[..., 0] * gw - ci
    t_y = gt_boxes[..., 1] * gh - cj
    anc_w = all_anc[best_n][..., 0]
    anc_h = all_anc[best_n][..., 1]
    t_w = torch.log((gt_boxes[..., 2] * net_w).clamp_min(1e-9)
                    / anc_w.clamp_min(1e-9))
    t_h = torch.log((gt_boxes[..., 3] * net_h).clamp_min(1e-9)
                    / anc_h.clamp_min(1e-9))
    scale = 2.0 - gt_boxes[..., 2] * gt_boxes[..., 3]

    # logits at the assigned sites; at colliding sites the gradient of
    # the gather adds up, as jnp's does
    bi = torch.arange(b, device=dev)[:, None]
    z_x = tx_z[bi, an, cj, ci]
    z_y = ty_z[bi, an, cj, ci]
    z_w = tw_z[bi, an, cj, ci]
    z_h = th_z[bi, an, cj, ci]
    z_o = obj_z[bi, an, cj, ci]
    z_c = cls_z[bi, an, cj, ci]                                # [B,T,nc]

    # darknet's collision semantics: the last writer at a site wins box
    # and objectness; the class target is the union of the one-hots
    t_n = truths.shape[1]
    t_idx = torch.arange(t_n, device=dev)
    later = t_idx[None, :] > t_idx[:, None]                    # [T,T]
    same_site = (assign[:, :, None] & assign[:, None, :]
                 & (an[:, :, None] == an[:, None, :])
                 & (cj[:, :, None] == cj[:, None, :])
                 & (ci[:, :, None] == ci[:, None, :]))         # [B,T,T]
    overwritten = torch.any(same_site & later[None], dim=2)
    is_last = assign & ~overwritten
    same_cls = same_site & (gt_cls[:, :, None] == gt_cls[:, None, :])
    cls_dup = torch.any(same_cls & later[None], dim=2)

    m = is_last.float()
    coord_loss = torch.sum(m * scale * (
        _bce_from_logits(z_x, t_x) + _bce_from_logits(z_y, t_y)
        + 0.5 * (z_w - t_w) ** 2 + 0.5 * (z_h - t_h) ** 2))
    obj_pos_loss = torch.sum(m * _bce_from_logits(z_o, 1.0))
    cls_onehot = _one_hot(gt_cls, nc)
    own = gt_cls.clamp(0, nc - 1)[..., None]    # jnp's mode="clip"
    z_own = z_c.gather(-1, own)[..., 0]
    if not focal:
        # the last writer carries the full one-hot BCE vector; each
        # earlier colliding GT only flips its own class entry 0 -> 1,
        # worth BCE(z, 1) - BCE(z, 0) = -z (once per class at a site)
        cls_loss = torch.sum(m[..., None] * _bce_from_logits(z_c,
                                                             cls_onehot))
        m_flip = (assign & ~is_last & ~cls_dup).float()
        cls_loss = cls_loss + torch.sum(m_flip * (-z_own))
    else:
        # focal inverts the attribution: the first writer writes the
        # focal-weighted full vector; each later colliding GT finds its
        # entry set and overwrites it with the plain delta (once per
        # site and class)
        earlier = t_idx[None, :] < t_idx[:, None]
        is_first = assign & ~torch.any(same_site & earlier[None], dim=2)
        pt = torch.sigmoid(z_c).gather(-1, own)[..., 0] + 1e-15
        grad_f = -(1.0 - pt) * (2.0 * pt * torch.log(pt) + pt - 1.0)
        w_f = 0.5 * grad_f.detach()                            # alpha 0.5
        mf = is_first.float()
        cls_loss = torch.sum((mf * w_f)[..., None]
                             * _bce_from_logits(z_c, cls_onehot))
        flip_keep = (assign & ~is_first & ~cls_dup).float()
        # the one first writer at each flipper's site: its focal weight
        # and whether its one-hot had the flipper's class set
        first_sel = (same_site & is_first[:, None, :]).float()
        wf_first = torch.sum(first_sel * w_f[:, None, :], dim=2)
        tgt_first = torch.sum(
            first_sel * (gt_cls[:, None, :] == gt_cls[:, :, None]), dim=2)
        cls_loss = cls_loss + torch.sum(flip_keep * (
            _bce_from_logits(z_own, 1.0)
            - wf_first * _bce_from_logits(z_own, tgt_first)))

    # background objectness everywhere, less what the assigned sites
    # would have taken (darknet overwrites the delta there)
    bg = obj_weight * _bce_from_logits(obj_z, torch.zeros_like(obj_z))
    assigned_bg = m * obj_weight[bi, an, cj, ci] * _bce_from_logits(z_o,
                                                                    0.0)
    obj_bg_loss = torch.sum(bg) - torch.sum(assigned_bg)

    total = coord_loss + obj_pos_loss + cls_loss + obj_bg_loss
    # count and avg_iou tally every assigned GT, collisions included
    # (darknet counts per truth, yolo_layer.c:276-278)
    with torch.no_grad():
        n_assign = torch.sum(assign.float())
        avg_iou = torch.sum(torch.where(
            assign, _iou_xywh(pred[bi, an, cj, ci], gt_boxes), 0.0)
        ) / n_assign.clamp_min(1.0)
    metrics = {"coord": coord_loss.detach(), "obj": obj_pos_loss.detach(),
               "cls": cls_loss.detach(), "noobj": obj_bg_loss.detach(),
               "count": n_assign, "avg_iou": avg_iou}
    return total, metrics


def _canonical_anchor_order(head_specs):
    """The cfg's full anchor list from the heads' masked subsets: cfg
    order is small to large, so the groups are sorted by area."""
    groups = [list(hs.anchors) for hs in head_specs]
    groups_sorted = sorted(groups, key=lambda g: np.mean(
        [w * h for w, h in g]) if g else 0)
    return [a for g in groups_sorted for a in g]


def yolo_loss(model, images, truths, net_w, net_h):
    """Total loss over the [yolo] heads of `model` (a `Darknet`, in the
    mode the caller set: train mode for darknet's batch-statistic batch
    norm), divided by the batch, and the metrics as {"head<k>/<name>"}.
    images: [B, H, W, 3]; truths [B, T, 5] normalized, x == 0 padding."""
    raw_heads = model(images, decode=False)
    head_specs = [l for l in model.spec.layers if l.kind == "yolo"]
    all_anchors = _canonical_anchor_order(head_specs)
    total = 0.0
    metrics = {}
    for k, (raw, hs) in enumerate(zip(raw_heads, head_specs)):
        li, m = head_loss(raw.float(), hs.anchors, all_anchors,
                          hs.num_classes, net_w, net_h, truths,
                          hs.ignore_thresh, focal=hs.focal_loss)
        total = total + li
        for mk, mv in m.items():
            metrics[f"head{k}/{mk}"] = mv
    return total / images.shape[0], metrics
