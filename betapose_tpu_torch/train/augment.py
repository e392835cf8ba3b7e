"""KPD training augmentation (the DPG pipeline), batched on the device.

Counterpart of `betapose_tpu/train/augment.py`, with the reference's
constants (`train_KPD/src/utils/pose.py:18-145`, generateSampleBox):

- per-channel color jitter U(0.7, 1.3), clamped to [0, 1];
- RGB mean offsets (-0.406, -0.457, -0.480);
- the box padded by U(0.2, 0.3)/2 per side, clamped to the image;
- DPG: with p = 0.15 an aspect-preserving random patch, else gaussian-
  perturbed corners; then, with more than 13 joints visible, one of 8
  half-crops at p = 0.04 each;
- visible joints: x > 0 and strictly inside the box;
- the crop (`ops/image.crop_box_matmul`) to (inputResH, inputResW), all
  zero when no joint is visible;
- labels: `transform_box` (rounded), then `draw_gaussian_batch` at
  sigma = hmGauss, zero for joints outside the box; set_mask all ones;
- flip at p = 0.5 (no left/right swap: LineMod keypoints have none);
- rotation r = clip(N(0, 30), +-60) with p = 0.4, else 0; the image is
  rotated by two 1-D bilinear passes (`rotate_image_shear`) and the label
  points are rotated analytically, then rounded.

The JAX package augments one sample at a time under `vmap` and branches
with `lax.cond`/`lax.switch`.  Here the whole batch is computed at once:
both DPG box branches and all 9 half-crop variants are formed for every
sample and the right one is selected with `torch.where`/`gather`, with no
host sync.  The random draws come from a `torch.Generator` on the device,
or from a `draws` dict (one tensor per draw, see `DRAWS`), which is how
the tests feed the values `jax.random` gives the JAX package.

Layouts: images NHWC in, inputs NHWC out, labels and set_mask
[B, K, oH, oW] (the port's heatmap layout; the JAX package's are NHWC).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from betapose_tpu_torch.ops.heatmap import draw_gaussian_batch
from betapose_tpu_torch.ops.image import (KPD_RGB_OFFSETS, _bilinear_gather,
                                          crop_box_matmul)

# the per-sample draws of the JAX `_augment_one`, with their shapes per
# sample; all are uniform on [0, 1) unless noted
DRAWS = {
    "jit3": (3,),        # U(0.7, 1.3): color jitter (keys[0])
    "rate": (),          # U(scale_min, scale_max): box padding (keys[1])
    "patch_scale": (),   # DPG: > 0.85 takes the patch branch (keys[2])
    "patch_u": (2,),     # DPG patch origin (keys[3], keys[4])
    "gauss": (4,),       # N(0, 1): DPG corner perturbation (keys[5])
    "switch": (),        # DPG half-crop choice (keys[6])
    "flip_u": (),        # flip when < 0.5 (keys[7])
    "rot_n": (),         # N(0, 1): rotation angle / rotate (keys[8])
    "rot_u": (),         # no rotation when < 0.6 (keys[9])
}
# DPG half-crop thresholds (pose.py:83-105): variant i when switch exceeds
# HALF_CROP[i] and no earlier one; the last is the box itself
HALF_CROP = (0.96, 0.92, 0.88, 0.84, 0.80, 0.76, 0.72, 0.68, -1.0)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    inp_h: int = 320
    inp_w: int = 256
    out_h: int = 80
    out_w: int = 64
    scale_min: float = 0.2
    scale_max: float = 0.3
    rotate: float = 30.0
    hm_gauss: int = 1
    add_dpg: bool = False
    train: bool = True
    flip: bool = True            # reference flips at p=0.5 (pose.py:131)


def draw_random(batch: int, cfg: AugmentConfig, generator: torch.Generator):
    """The draws of one batch from `generator`, on its device."""
    dev = generator.device

    def u(*shape):
        return torch.rand((batch, *shape), generator=generator, device=dev)

    def n(*shape):
        return torch.randn((batch, *shape), generator=generator, device=dev)

    return {"jit3": 0.7 + 0.6 * u(3),
            "rate": cfg.scale_min + (cfg.scale_max - cfg.scale_min) * u(),
            "patch_scale": u(), "patch_u": u(2), "gauss": n(4),
            "switch": u(), "flip_u": u(), "rot_n": n(), "rot_u": u()}


def transform_box(pt, ul, br, inp_h, inp_w, res_h, res_w):
    """Image coords -> heatmap coords, rounded (`transformBox`,
    KPD/src/utils/img.py:178-196).  pt [B,K,2]; ul, br [B,2]."""
    center_x = (br[:, 0] - 1 - ul[:, 0]) / 2
    center_y = (br[:, 1] - 1 - ul[:, 1]) / 2
    len_h = torch.maximum(br[:, 1] - ul[:, 1],
                          (br[:, 0] - ul[:, 0]) * inp_h / inp_w)
    len_w = len_h * inp_w / inp_h
    x = (pt[..., 0] - ul[:, 0:1]
         + ((len_w - 1) / 2 - center_x).clamp_min(0.0)[:, None])
    y = (pt[..., 1] - ul[:, 1:2]
         + ((len_h - 1) / 2 - center_y).clamp_min(0.0)[:, None])
    out = torch.stack([x, y], dim=-1) * res_h / len_h[:, None, None]
    return torch.round(out)


def _rotate_image(img, deg):
    """Rotate img [B,H,W,C] about its centre by deg [B] degrees (torchsample
    Rotate: output(x) = input(R^-1 x), bilinear, zero fill) with one 2-D
    gather per pixel: the semantic oracle of `rotate_image_shear`."""
    _, h, w, _ = img.shape
    theta = (-deg * math.pi / 180.0)[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    ys, xs = ys - cy, xs - cx
    cos, sin = torch.cos(theta), torch.sin(theta)
    src_x = cos * xs - sin * ys + cx
    src_y = sin * xs + cos * ys + cy
    return _bilinear_gather(img, src_y, src_x)


def _hat_resample(img, src, dim: int):
    """out[..., o, ...] = sum_j clip(1 - |src_o - j|, 0) * img[..., j, ...]
    along `dim` (1: rows, 2: columns) of img [B,H,W,C], src [B,H,W]: the
    JAX package's dense hat-weight product, computed from the two taps
    floor(src) and floor(src) + 1 that can be non-zero, with the same
    weights; taps outside the image read zero."""
    n = img.shape[dim]
    j0 = torch.floor(src)
    out = 0.0
    for j in (j0, j0 + 1.0):
        wgt = (1.0 - (src - j).abs()).clamp_min(0.0)
        wgt = wgt * ((j >= 0) & (j < n))
        idx = j.clamp(0, n - 1).long()[..., None].expand(-1, -1, -1,
                                                         img.shape[3])
        out = out + wgt[..., None] * img.gather(dim, idx)
    return out


def rotate_image_shear(img, deg):
    """The rotation of `_rotate_image` as the JAX package computes it: a
    bilinear x-pass then a y-pass (Catmull-Smith), R(theta) = [[p, q],
    [0, 1]] @ [[1, 0], [r, s]] with p = 1/cos, q = -tan, r = sin, s = cos,
    theta = -deg*pi/180.  img [B,H,W,C], deg [B]; valid for |deg| < 90."""
    _, h, w, _ = img.shape
    theta = (-deg * math.pi / 180.0)[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    p, q = 1.0 / cos, -torch.tan(theta)
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    # x-pass: out1[i, xo] = img[i, p*(xo-cx) + q*(i-cy) + cx]
    out1 = _hat_resample(img, p * (xs - cx) + q * (ys - cy) + cx, 2)
    # y-pass: out[yo, x] = out1[r*(x-cx) + s*(yo-cy) + cy, x]
    return _hat_resample(out1, sin * (xs - cx) + cos * (ys - cy) + cy, 1)


def rotate_points(pts, deg, res_h: int, res_w: int):
    """Where `_rotate_image` moves a feature at p: R(theta)^-1 (p - c) + c.
    pts [B,K,2] (x, y) in a res_h x res_w canvas; deg [B]."""
    phi = (deg * math.pi / 180.0)[:, None]       # = -theta
    cx, cy = (res_w - 1) / 2.0, (res_h - 1) / 2.0
    dx = pts[..., 0] - cx
    dy = pts[..., 1] - cy
    cos, sin = torch.cos(phi), torch.sin(phi)
    return torch.stack([cos * dx - sin * dy + cx,
                        sin * dx + cos * dy + cy], dim=-1)


def _visible(part, ul, br):
    """[B,K] joints with x > 0 strictly inside the box (pose.py:76-80)."""
    x, y = part[..., 0], part[..., 1]
    return ((x > 0) & (x > ul[:, 0:1]) & (y > ul[:, 1:2])
            & (x < br[:, 0:1]) & (y < br[:, 1:2]))


def crop_boxes(bndboxes, parts, d, cfg: AugmentConfig, img_h: int,
               img_w: int):
    """The crop box of every sample (pose.py:36-105): the box floored and
    padded by `rate`/2 per side, clamped to the image; then, in train mode
    with DPG, the patch or the gaussian branch, and a half-crop when more
    than 13 joints are visible.  Returns (ul, br, variant [B]): variant
    0-7 is the half-crop taken, 8 none."""
    ul = torch.floor(bndboxes[:, :2])
    br = torch.floor(bndboxes[:, 2:])
    width = br[:, 0] - ul[:, 0]
    ht = br[:, 1] - ul[:, 1]
    wh = torch.stack([width, ht], dim=1)
    rate = d["rate"][:, None]
    ul = (ul - wh * rate / 2).clamp_min(0.0)
    br = torch.minimum(torch.tensor([img_w - 1.0, img_h - 1.0],
                                    device=ul.device), br + wh * rate / 2)
    variant = torch.full_like(width, 8, dtype=torch.long)
    if not (cfg.add_dpg and cfg.train):
        return ul, br, variant

    ps = d["patch_scale"]
    ratio = ht / width
    patch_w = torch.where(width < ht, ps * width, ps * ht / ratio)
    patch_h = torch.where(width < ht, ps * width * ratio, ps * ht)
    xmin = ul[:, 0] + d["patch_u"][:, 0] * (width - patch_w)
    ymin = ul[:, 1] + d["patch_u"][:, 1] * (ht - patch_h)
    patch = torch.stack([xmin, ymin, xmin + patch_w + 1, ymin + patch_h + 1],
                        dim=1)

    g = d["gauss"]
    gx0 = (ul[:, 0] + (g[:, 0] * 0.1158 - 0.0142) * width).clamp(
        1.0, img_w - 3.0)
    gy0 = (ul[:, 1] + (g[:, 1] * 0.068 + 0.0043) * ht).clamp(1.0, img_h - 3.0)
    gx1 = torch.maximum(gx0 + 2, br[:, 0] + (g[:, 2] * 0.1337 + 0.0154)
                        * width).clamp(0.0, img_w - 3.0)
    gy1 = torch.maximum(gy0 + 2, br[:, 1] + (g[:, 3] * 0.0711 - 0.0013)
                        * ht).clamp(0.0, img_h - 3.0)
    gauss = torch.stack([gx0, gy0, gx1, gy1], dim=1)
    box = torch.where((ps > 0.85)[:, None], patch, gauss)
    ul, br = box[:, :2], box[:, 2:]

    joint_num = _visible(parts, ul, br).sum(1)
    thresholds = torch.tensor(HALF_CROP, device=ul.device)
    variant = torch.argmax((d["switch"][:, None] > thresholds).int(), dim=1)
    variant = torch.where(joint_num > 13, variant, 8)
    (ux, uy), (bx, by) = ul.unbind(1), br.unbind(1)
    mx, my = ((ul + br) / 2.0).unbind(1)
    crops = torch.stack([
        torch.stack(c, dim=1) for c in (
            (ux, uy, mx, my), (mx, uy, bx, my), (ux, my, mx, by),
            (mx, my, bx, by), (ux, uy, mx, by), (mx, uy, bx, by),
            (ux, uy, bx, my), (ux, my, bx, by), (ux, uy, bx, by))],
        dim=1)                                            # [B,9,4]
    box = crops.gather(1, variant[:, None, None].expand(-1, 1, 4))[:, 0]
    return box[:, :2], box[:, 2:], variant


def augment_batch(imgs, bndboxes, parts, cfg: AugmentConfig,
                  generator: torch.Generator | None = None, draws=None,
                  kp_vis=None):
    """imgs [B,H,W,3] RGB in [0,1]; bndboxes [B,4] xyxy; parts [B,K,2];
    kp_vis: optional [B,K] visibility in [0,1] (an occluded keypoint gets a
    zero target).  Random draws come from `generator` (on the images'
    device) or, when given, from `draws` (a dict of the `DRAWS` tensors,
    each [B, *shape]).  Eval mode (cfg.train False) reads only `rate`, as
    the JAX package's does: no jitter, DPG, flip or rotation.
    Returns dict(inps [B,iH,iW,3], labels [B,K,oH,oW], set_mask)."""
    b, h, w, _ = imgs.shape
    dev = imgs.device
    imgs = imgs.float()
    bndboxes = bndboxes.float()
    parts = parts.float()
    d = draw_random(b, cfg, generator) if draws is None else draws

    img = imgs
    if cfg.train:
        img = (img * d["jit3"][:, None, None, :]).clamp(0.0, 1.0)
    img = img + torch.tensor(KPD_RGB_OFFSETS, device=dev)

    ul, br, _ = crop_boxes(bndboxes, parts, d, cfg, h, w)
    joint_num = _visible(parts, ul, br).sum(1)
    inp = crop_box_matmul(img, ul, br, cfg.inp_h, cfg.inp_w)
    inp = torch.where((joint_num == 0)[:, None, None, None],
                      torch.zeros((), device=dev), inp)
    vis = _visible(parts, ul, br)
    hm_pts = transform_box(parts, ul, br, cfg.inp_h, cfg.inp_w,
                           cfg.out_h, cfg.out_w)

    if cfg.train:
        do_flip = (d["flip_u"] < 0.5) & cfg.flip
        inp = torch.where(do_flip[:, None, None, None], inp.flip(2), inp)
        r = (d["rot_n"] * cfg.rotate).clamp(-2 * cfg.rotate, 2 * cfg.rotate)
        r = torch.where(d["rot_u"] < 0.6, torch.zeros((), device=dev), r)
        inp = torch.where((r != 0)[:, None, None, None],
                          rotate_image_shear(inp, r), inp)
        # the reference flips and rotates the drawn heatmaps; for isotropic
        # gaussians that is moving their centres, so the points move and
        # are drawn once (the gaussian stays crisp at the rounded centre
        # instead of picking up the resampling blur: PARITY.md)
        flipped_x = torch.where(do_flip[:, None],
                                cfg.out_w - 1.0 - hm_pts[..., 0],
                                hm_pts[..., 0])
        hm_pts = torch.stack([flipped_x, hm_pts[..., 1]], dim=-1)
        hm_pts = torch.round(rotate_points(hm_pts, r, cfg.out_h, cfg.out_w))

    labels = draw_gaussian_batch(hm_pts, cfg.out_h, cfg.out_w,
                                 sigma=cfg.hm_gauss)
    labels = labels * vis[..., None, None]
    if kp_vis is not None:
        labels = labels * kp_vis.float()[..., None, None]
    return {"inps": inp, "labels": labels,
            "set_mask": torch.ones_like(labels)}
