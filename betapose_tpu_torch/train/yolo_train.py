"""YOLOv3 training with darknet's semantics: the SGD, the LR schedule, the
detection augmentation on the device, and the train step.

Counterpart of `betapose_tpu/train/yolo_train.py` (reference
`train_YOLO/src/detector.c:38-232` train_detector, `src/data.c:811-862`
load_data_detection, `src/network.c` SGD):

- SGD with momentum, weight decay on the conv weights only (darknet
  decays neither biases nor batch-norm parameters), optax's arithmetic
  (`make_optimizer`);
- the LR: burn-in lr * (step / burn_in)^4, then x scale past each of the
  cfg's steps (`lr_schedule`, darknet's get_current_rate);
- augmentation, batched on the device with no host sync: a crop-jitter of
  +-jitter per side, resampled by two float32 matmuls, a horizontal flip
  at p = 0.5, boxes remapped to the viewport and clipped, then HSV
  distortion (hue +-hue, saturation and exposure scaled by [1, x] or its
  inverse);
- the train step: forward and backward with the convs in the train
  precision (`models/precision`), darknet's batch-statistic batch norm,
  one optimizer update.

The random draws come from a `torch.Generator` on the device or from a
`draws` dict (one tensor per draw, see `DRAWS`), which is how the tests
feed the values `jax.random` gives the JAX package.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from betapose_tpu_torch.models import yolov3 as yolo_mod
from betapose_tpu_torch.models.precision import conv_precision
from betapose_tpu_torch.parallel import collectives as coll
from betapose_tpu_torch.train.kpd_train import (DEFAULT_TRAIN_PRECISION,
                                                Optimizer)
from betapose_tpu_torch.train.yolo_loss import yolo_loss

# the per-sample draws of the JAX augmentation, each [B]: the crop's four
# side offsets in pixels (U(-jitter*dim, jitter*dim)), the flip (flip when
# < 0.5), the hue shift (U(-hue, hue)), and saturation and exposure as a
# scale in [1, x] and a uniform that inverts it when > 0.5
DRAWS = ("pleft", "pright", "ptop", "pbot", "flip_u", "dhue", "sat_s",
         "sat_u", "exp_s", "exp_u")


@dataclasses.dataclass
class YoloTrainConfig:
    """The JAX `YoloTrainConfig` less its `flip` and `ignore_thresh`, which
    neither trainer reads (the flip is always drawn; each [yolo] head
    carries its own ignore_thresh)."""
    lr: float = 1e-3
    burn_in: int = 1000
    steps: tuple = (3000, 5000)
    scales: tuple = (0.1, 0.1)
    momentum: float = 0.9
    decay: float = 5e-4
    max_batches: int = 6100
    jitter: float = 0.3
    hue: float = 0.1
    saturation: float = 1.5
    exposure: float = 1.5
    max_boxes: int = 10


def lr_schedule(cfg: YoloTrainConfig):
    """darknet's get_current_rate for policy=steps with burn_in
    (network.c:110-140), in float32 as the JAX package computes it:
    lr(step) is a numpy float32."""
    f32 = np.float32

    def lr(step):
        step = f32(step)
        if step < cfg.burn_in:
            return f32(cfg.lr) * np.power(step / f32(max(cfg.burn_in, 1)),
                                          f32(4.0))
        rate = f32(cfg.lr)
        for s, sc in zip(cfg.steps, cfg.scales):
            if step > s:
                rate = rate * f32(sc)
        return rate
    return lr


class YoloOptimizer(Optimizer):
    """optax's `masked(chain(masked(add_decayed_weights(decay), conv
    weights), sgd(lr_schedule, momentum)), not the BN running stats)`, the
    JAX `make_optimizer`:

    - g = g + decay * p on the conv weights alone (two parameter groups);
    - t = g + momentum * t; p = p - lr(count) * t;
    - `count` is the schedule's step: the first update takes lr(0), and
      `fast_forward_opt_state` sets it for a resumed run.

    The running statistics are buffers, which no optimizer sees."""

    def __init__(self, model: yolo_mod.Darknet, cfg: YoloTrainConfig):
        decayed = [m.conv.weight for _, m in yolo_mod.conv_layers(model)]
        ids = {id(p) for p in decayed}
        rest = [p for p in model.parameters() if id(p) not in ids]
        super().__init__([{"params": decayed, "weight_decay": cfg.decay},
                          {"params": rest, "weight_decay": 0.0}],
                         "sgd", cfg.lr, cfg.momentum)
        self.schedule = lr_schedule(cfg)
        self.count = 0

    def step(self):
        lr = float(self.schedule(self.count))
        for group in self.param_groups:
            group["lr"] = lr
        super().step()
        self.count += 1


def make_optimizer(model, cfg: YoloTrainConfig) -> YoloOptimizer:
    return YoloOptimizer(model, cfg)


def fast_forward_opt_state(optimizer: YoloOptimizer, start_iter: int):
    """Resume: darknet's get_current_rate reads net.seen, so a resumed run
    continues the LR schedule mid-curve; the schedule's count is set to
    the resumed iteration."""
    if start_iter > 0:
        optimizer.count = int(start_iter)
    return optimizer


# ---------------------------------------------------------------------------
# Detection augmentation on the device
# ---------------------------------------------------------------------------

def _rgb_to_hsv(rgb):
    """[..., 3] RGB in [0, 1] -> HSV, h in [0, 1)."""
    r, g, b = rgb.unbind(-1)
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    s = torch.where(mx > 0, d / mx.clamp_min(1e-12), 0.0)
    dd = d.clamp_min(1e-12)
    rc = torch.where(d > 0, (mx - r) / dd, 0.0)
    gc = torch.where(d > 0, (mx - g) / dd, 0.0)
    bc = torch.where(d > 0, (mx - b) / dd, 0.0)
    h = torch.where(mx == r, bc - gc,
                    torch.where(mx == g, 2.0 + rc - bc, 4.0 + gc - rc))
    # remainder floors, as jnp's %, where fmod would truncate
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(d > 0, h, 0.0)
    return torch.stack([h, s, mx], dim=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv.unbind(-1)
    h = h * 6.0
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    idx = torch.remainder(i.long(), 6)

    def pick(table):   # jnp.select over idx == 0..4, the last the default
        out = table[5]
        for k in range(4, -1, -1):
            out = torch.where(idx == k, table[k], out)
        return out

    return torch.stack([pick((v, q, p, p, t, v)), pick((t, v, v, q, p, p)),
                        pick((p, p, t, v, v, q))], dim=-1)


def _scale(s, u):
    return torch.where(u > 0.5, 1.0 / s, s)


def distort_hsv(imgs, d):
    """darknet random_distort_image (image.c:1693) on imgs [B, H, W, 3]:
    hue shifted by dhue (wrapped), saturation and exposure scaled, each
    clipped to [0, 1]."""
    hsv = _rgb_to_hsv(imgs)
    col = (slice(None), None, None)
    h = torch.remainder(hsv[..., 0] + d["dhue"][col], 1.0)
    s = (hsv[..., 1] * _scale(d["sat_s"], d["sat_u"])[col]).clamp(0.0, 1.0)
    v = (hsv[..., 2] * _scale(d["exp_s"], d["exp_u"])[col]).clamp(0.0, 1.0)
    return _hsv_to_rgb(torch.stack([h, s, v], dim=-1))


def crop_jitter(imgs, boxes, box_valid, d, out_h: int, out_w: int):
    """darknet's crop-jitter on imgs [B, H, W, 3]: the viewport [pleft,
    w - pright] x [ptop, h - pbot] (zero outside the image) resampled to
    (out_h, out_w) by hat-weight matrices, two float32 matmuls; then the
    flip, and the boxes [B, T, 5] (x, y, w, h, cls) remapped, clipped to
    [0, 1] and kept when wider and taller than 0.001."""
    b, h, w, c = imgs.shape
    dev = imgs.device
    pleft, pright, ptop, pbot = (d[k][:, None] for k in
                                 ("pleft", "pright", "ptop", "pbot"))
    swidth = w - pleft - pright
    sheight = h - ptop - pbot
    ys = ((torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5)
          / out_h * sheight + ptop - 0.5)                      # [B,oh]
    xs = ((torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5)
          / out_w * swidth + pleft - 0.5)                      # [B,ow]
    rows = torch.arange(h, dtype=torch.float32, device=dev)
    cols = torch.arange(w, dtype=torch.float32, device=dev)
    wy = (1.0 - (ys[..., None] - rows).abs()).clamp_min(0.0)  # [B,oh,H]
    wx = (1.0 - (xs[..., None] - cols).abs()).clamp_min(0.0)  # [B,ow,W]
    tmp = torch.bmm(wy, imgs.reshape(b, h, w * c))             # [B,oh,W*c]
    tmp = tmp.reshape(b, out_h, w, c).permute(0, 2, 1, 3)
    out = torch.bmm(wx, tmp.reshape(b, w, out_h * c))          # [B,ow,oh*c]
    out = out.reshape(b, out_w, out_h, c).permute(0, 2, 1, 3)

    do_flip = d["flip_u"] < 0.5
    out = torch.where(do_flip[:, None, None, None], out.flip(2), out)

    bx = (boxes[..., 0] * w - pleft) / swidth
    by = (boxes[..., 1] * h - ptop) / sheight
    bw = boxes[..., 2] * w / swidth
    bh = boxes[..., 3] * h / sheight
    bx = torch.where(do_flip[:, None], 1.0 - bx, bx)
    x1 = (bx - bw / 2).clamp(0.0, 1.0)
    x2 = (bx + bw / 2).clamp(0.0, 1.0)
    y1 = (by - bh / 2).clamp(0.0, 1.0)
    y2 = (by + bh / 2).clamp(0.0, 1.0)
    nbw, nbh = x2 - x1, y2 - y1
    valid = box_valid & (nbw > 0.001) & (nbh > 0.001)
    new_boxes = torch.stack(
        [torch.where(valid, v, 0.0) for v in
         ((x1 + x2) / 2, (y1 + y2) / 2, nbw, nbh)] + [boxes[..., 4]], dim=-1)
    return out.contiguous(), new_boxes


def draw_random(batch: int, h: int, w: int, cfg: YoloTrainConfig,
                generator: torch.Generator):
    """The `DRAWS` of one batch of h x w frames from `generator`, on its
    device."""
    dev = generator.device

    def u(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(batch, generator=generator,
                                           device=dev)

    dw, dh = cfg.jitter * w, cfg.jitter * h
    return {"pleft": u(-dw, dw), "pright": u(-dw, dw), "ptop": u(-dh, dh),
            "pbot": u(-dh, dh), "flip_u": u(), "dhue": u(-cfg.hue, cfg.hue),
            "sat_s": u(1.0, cfg.saturation), "sat_u": u(),
            "exp_s": u(1.0, cfg.exposure), "exp_u": u()}


def augment_detection_batch(imgs, truths, cfg: YoloTrainConfig, out_h: int,
                            out_w: int, generator: torch.Generator | None
                            = None, draws=None):
    """imgs [B, H, W, 3] float in [0, 1]; truths [B, T, 5] normalized.
    Draws from `generator` (on the images' device) or, when given, from
    `draws` (the `DRAWS`, each [B]).  Returns (images [B, out_h, out_w, 3],
    truths [B, T, 5])."""
    b, h, w, _ = imgs.shape
    d = draw_random(b, h, w, cfg, generator) if draws is None else draws
    out, tr = crop_jitter(imgs.float(), truths, truths[..., 0] != 0, d,
                          out_h, out_w)
    return distort_hsv(out, d), tr


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def make_train_step(model: yolo_mod.Darknet, optimizer, net_w: int,
                    net_h: int, precision: str = DEFAULT_TRAIN_PRECISION,
                    group=None):
    """train_step(images, truths) -> metrics (device scalars, no host
    sync): "loss" and "head<k>/<name>".  One forward and backward in train
    mode with the convs in `precision` ("bfloat16", the JAX default:
    bf16 operands, float32 sums; "tensorfloat32"; "float32"), then one
    optimizer update.  The batch norms roll their running statistics in
    the forward; the optimizer neither reads nor writes them, so this is
    the JAX order's result (the update, then `apply_bn_updates`).

    Data parallelism: with `group` (the mesh's `data` axis), images and
    truths are this rank's rows of the global batch.  The JAX loss is the
    heads' sum over the batch divided by the global batch, so each rank's
    loss is its rows' sum over the global batch and the gradients are
    all-reduced as a sum (a mean would be 1/n of the JAX update).  The
    logged loss and the head metrics are summed over the group, avg_iou
    weighted by the counts, before JAX's normalisation."""
    params = list(model.parameters())
    n = coll.group_size(group)

    def train_step(images, truths):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with conv_precision(model, precision):
            loss, metrics = yolo_loss(model, images, truths, net_w, net_h)
            if group is not None:
                loss = loss / n    # this rank's rows over the global batch
            loss.backward()
        coll.all_reduce_grads(params, group, "sum")
        optimizer.step()
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        if group is not None:
            metrics = _sum_metrics(metrics, group)
        return metrics

    return train_step


@torch.no_grad()
def _sum_metrics(metrics, group):
    """The global batch's metrics: sums summed; avg_iou, a mean over the
    head's count, weighted by the counts."""
    keys = sorted(metrics)
    vals = []
    for k in keys:
        v = metrics[k]
        if k.endswith("/avg_iou"):
            v = v * metrics[k[:-len("avg_iou")] + "count"].clamp_min(1.0)
        vals.append(v.float())
    tot = dict(zip(keys, coll.all_reduce_sum(torch.stack(vals), group)))
    for k in keys:
        if k.endswith("/avg_iou"):
            tot[k] = tot[k] / tot[k[:-len("avg_iou")] + "count"].clamp_min(
                1.0)
    return tot


def load_darknet_labels(list_file, max_boxes: int = 10):
    """Read a darknet train list: each line an image path; labels at the
    sibling .txt ('class cx cy w h' normalized, scripts/*_object.py).
    Returns (paths, truths [N, max_boxes, 5] with (x,y,w,h,cls))."""
    paths = [ln.strip() for ln in open(list_file) if ln.strip()]
    truths = np.zeros((len(paths), max_boxes, 5), np.float32)
    for i, p in enumerate(paths):
        txt = os.path.splitext(p)[0] + ".txt"
        if not os.path.exists(txt):
            txt = p.replace("images", "labels").rsplit(".", 1)[0] + ".txt"
        if not os.path.exists(txt):
            continue
        rows = []
        for ln in open(txt):
            vals = ln.split()
            if len(vals) >= 5:
                cls, cx, cy, w, h = (float(v) for v in vals[:5])
                rows.append([cx, cy, w, h, cls])
        for j, r in enumerate(rows[:max_boxes]):
            truths[i, j] = r
    return paths, truths
