"""Image ops on the device: stretch/letterbox resize, box expansion, the
affine box crop and the heatmap -> image coordinate inverse.

Counterpart of `betapose_tpu/ops/image.py`.  Resampling keeps the
separable-matmul form (output = R_y @ img @ R_x^T with hat-function weight
rows), so the weights are the JAX package's exactly; the per-frame `vmap`
there is a batch dimension here.  Weights are built in float32 and cast to
the image dtype: float32 inputs give float32 products (TF32 is off, see
`core/device.py`), bfloat16 inputs (the network feed on the card) run bf16
products with float32 accumulation, as the JAX bf16 path does.

Layouts follow the JAX package: images NHWC, boxes xyxy.
"""

from __future__ import annotations

import torch

# Per-channel offsets added to RGB in [0,1] before KPD (dataloader.py:802-804).
KPD_RGB_OFFSETS = (-0.406, -0.457, -0.480)


def _interp_matrix(src: int, dst: int, antialias: bool, device):
    """[dst, src] row-normalized hat weights on the half-pixel grid."""
    scale = max(src / dst, 1.0) if antialias else 1.0
    pos = ((torch.arange(dst, dtype=torch.float32, device=device) + 0.5)
           * (src / dst) - 0.5)
    if not antialias:
        pos = pos.clamp(0.0, src - 1.0)
    grid = torch.arange(src, dtype=torch.float32, device=device)
    wmat = (1.0 - (pos[:, None] - grid[None, :]).abs() / scale).clamp_min(0.0)
    return wmat / wmat.sum(dim=1, keepdim=True)


def resize_bilinear_matmul(x, out_h: int, out_w: int,
                           antialias: bool = False):
    """Separable bilinear resize of x [B,H,W,C] to [B,out_h,out_w,C] as two
    matmuls on the half-pixel grid.

    antialias=False matches cv2.resize INTER_LINEAR (the reference pipeline's
    convention and the training augmentation's); antialias=True matches
    jax.image.resize 'linear' (scale-widened triangle kernel)."""
    _, h, w, _ = x.shape
    ry = _interp_matrix(h, out_h, antialias, x.device).to(x.dtype)
    rx = _interp_matrix(w, out_w, antialias, x.device).to(x.dtype)
    t = torch.einsum("ih,bhwc->biwc", ry, x)
    return torch.einsum("jw,biwc->bijc", rx, t)


def letterbox(img, dst_h: int, dst_w: int, fill: float = 128.0):
    """Aspect-preserving resize of [B,H,W,C] onto a fill-gray canvas of
    (dst_h, dst_w), with the integer geometry of `yolo/preprocess.py:19-31`
    (new_w = int(w*min(s)), offset = (dst-new)//2).  The resize is the
    antialiased triangle kernel of jax.image.resize 'linear', the JAX
    package's default method."""
    b, h, w, c = img.shape
    scale = min(dst_w / w, dst_h / h)
    new_w, new_h = int(w * scale), int(h * scale)
    resized = resize_bilinear_matmul(img, new_h, new_w, antialias=True)
    top = (dst_h - new_h) // 2
    left = (dst_w - new_w) // 2
    canvas = torch.full((b, dst_h, dst_w, c), fill, dtype=resized.dtype,
                        device=img.device)
    canvas[:, top:top + new_h, left:left + new_w] = resized
    return canvas


def _bilinear_gather(img, ys, xs, mask_val=0.0):
    """Sample img [B,H,W,C] at float coordinates ys, xs [B,h,w] ->
    [B,h,w,C], bilinear, with `mask_val` for neighbours outside the image
    (the JAX `_bilinear_gather`, batched)."""
    b, h, w, c = img.shape
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]
    flat = img.reshape(b, h * w, c)

    def get(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, -1, 1)
        vals = flat.gather(1, idx.expand(-1, -1, c)).reshape(*yi.shape, c)
        return torch.where(valid[..., None], vals,
                           torch.full((), mask_val, dtype=img.dtype,
                                      device=img.device))

    return ((1 - wy) * ((1 - wx) * get(y0, x0) + wx * get(y0, x0 + 1))
            + wy * ((1 - wx) * get(y0 + 1, x0) + wx * get(y0 + 1, x0 + 1)))


def crop_box_params(ul, br, res_h: int, res_w: int):
    """Canvas geometry of the reference cropBox for boxes ul, br [..., 2]
    (already floor-truncated).  Returns (len_h, len_w, pad_top, pad_left,
    box_h, box_w): crop [ul:br), center-pad (ceil before, floor after) to
    (len_h, len_w), bilinear align-corners resize to (res_h, res_w)."""
    box_w = br[..., 0] - ul[..., 0]
    box_h = br[..., 1] - ul[..., 1]
    len_h = torch.maximum(box_h, box_w * res_h / res_w)
    len_w = len_h * res_w / res_h
    len_h_i = torch.floor(len_h)
    len_w_i = torch.floor(len_w)
    pad_top = torch.ceil((len_h_i - box_h) / 2.0)
    pad_left = torch.ceil((len_w_i - box_w) / 2.0)
    return len_h_i, len_w_i, pad_top, pad_left, box_h, box_w


def crop_box_matmul(img, ul, br, res_h: int, res_w: int):
    """The reference `cropBox` (`KPD/src/utils/img.py:242-262`) as two
    matmuls per box: img [B,H,W,C] with one box per image, ul, br [B,2] ->
    [B,res_h,res_w,C], or N boxes per image, ul, br [B,N,2] ->
    [B,N,res_h,res_w,C] (each image's boxes read that image; it is not
    repeated).  Weight rows are clip(1 - |src - j|, 0) masked to the crop
    window [ul, br), which reproduces SpecialCrop+Pad's zero fill."""
    per_box = ul.dim() == 3
    if not per_box:
        ul, br = ul[:, None], br[:, None]
    _, h, w, _ = img.shape
    dev = img.device
    ul = torch.floor(ul.float())
    br = torch.floor(br.float())
    len_h, len_w, pad_top, pad_left, _, _ = crop_box_params(
        ul, br, res_h, res_w)

    ii = torch.arange(res_h, dtype=torch.float32, device=dev)
    jj = torch.arange(res_w, dtype=torch.float32, device=dev)
    src_y = (ii * (len_h[..., None] - 1.0) / (res_h - 1.0)
             - pad_top[..., None] + ul[..., 1:2])              # [B,N,res_h]
    src_x = (jj * (len_w[..., None] - 1.0) / (res_w - 1.0)
             - pad_left[..., None] + ul[..., 0:1])             # [B,N,res_w]

    rows = torch.arange(h, dtype=torch.float32, device=dev)
    cols = torch.arange(w, dtype=torch.float32, device=dev)
    wy = (1.0 - (src_y[..., None] - rows).abs()).clamp_min(0.0)
    wy = wy * ((rows >= ul[..., 1:2]) & (rows < br[..., 1:2]))[..., None, :]
    wx = (1.0 - (src_x[..., None] - cols).abs()).clamp_min(0.0)
    wx = wx * ((cols >= ul[..., 0:1]) & (cols < br[..., 0:1]))[..., None, :]

    tmp = torch.einsum("bnih,bhwc->bniwc", wy.to(img.dtype), img)
    out = torch.einsum("bnjw,bniwc->bnijc", wx.to(img.dtype), tmp)
    return out if per_box else out[:, 0]


def expand_boxes(boxes, img_h: int, img_w: int):
    """Reference `crop_from_dets` box expansion (`dataloader.py:802-825`):
    pad by scaleRate/2 per side (0.2 if width>100 else 0.3), clamp to the
    image with a 5px minimum extent.  boxes [N,4] xyxy -> (ul [N,2],
    br [N,2])."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    width = x2 - x1
    ht = y2 - y1
    rate = torch.where(width > 100, 0.2, 0.3)
    ul_x = (x1 - width * rate / 2).clamp_min(0.0)
    ul_y = (y1 - ht * rate / 2).clamp_min(0.0)
    br_x = torch.maximum((x2 + width * rate / 2).clamp_max(img_w - 1.0),
                         ul_x + 5)
    br_y = torch.maximum((y2 + ht * rate / 2).clamp_max(img_h - 1.0),
                         ul_y + 5)
    return torch.stack([ul_x, ul_y], dim=-1), torch.stack([br_x, br_y], dim=-1)


def crop_from_dets(imgs_rgb01, boxes, res_h: int, res_w: int):
    """Reference `crop_from_dets`, one box or N boxes per frame.

    imgs_rgb01: [B,H,W,3] RGB in [0,1]; boxes [B,4] or [B,N,4] xyxy.
    Returns (inps [B,(N,)res_h,res_w,3], pt1 [B,(N,)2], pt2 [B,(N,)2])."""
    _, h, w, _ = imgs_rgb01.shape
    img = imgs_rgb01 + torch.tensor(KPD_RGB_OFFSETS, dtype=imgs_rgb01.dtype,
                                    device=imgs_rgb01.device)
    ul, br = expand_boxes(boxes, h, w)
    return crop_box_matmul(img, ul, br, res_h, res_w), ul, br


def transform_box_invert_batch(pt, ul, br, inp_h: int, inp_w: int,
                               res_h: int, res_w: int):
    """Heatmap coords -> image coords (`transformBoxInvert_batch`,
    `KPD/src/utils/img.py:217-239`).  pt [n,K,2]; ul, br [n,2].

    The reference passes the FLOAT expanded corners here although cropBox
    truncated them to int for the crop itself; that sub-pixel inconsistency
    is kept for parity."""
    center = (br - 1 - ul) / 2.0
    size = br - ul
    size_h = torch.maximum(size[:, 1], size[:, 0] * (inp_h / inp_w))
    len_w = size_h * (inp_w / inp_h)

    _pt = pt * size_h[:, None, None] / res_h
    off_x = ((len_w - 1) / 2.0 - center[:, 0]).clamp_min(0.0)
    off_y = ((size_h - 1) / 2.0 - center[:, 1]).clamp_min(0.0)
    x = _pt[..., 0] - off_x[:, None] + ul[:, 0:1]
    y = _pt[..., 1] - off_y[:, None] + ul[:, 1:2]
    return torch.stack([x, y], dim=-1)
