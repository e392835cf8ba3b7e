"""Heatmap peak decoding back to image coordinates, and the peak
concentration statistic.

Counterpart of `betapose_tpu/ops/heatmap.py` (reference `getPrediction`,
`KPD/src/utils/eval.py:113-147`).  The peak stage is
`ops/kernels/heatmap_decode.decode_peaks`: the CUDA kernel for a tensor on
the card, its plain version for a tensor on the CPU.  Target rendering
(`draw_gaussian_batch`) is KPD training's (`train/augment.py`).
"""

from __future__ import annotations

import torch

from betapose_tpu_torch.ops.image import transform_box_invert_batch
from betapose_tpu_torch.ops.kernels.heatmap_decode import decode_peaks


def draw_gaussian_batch(pts, res_h: int, res_w: int, sigma: float = 1):
    """Render keypoints pts [N,K,2] (x, y) into heatmaps [N,K,res_h,res_w]
    float32, the reference `drawGaussian` (`KPD/src/utils/img.py:82-111`).

    The window is [trunc(pt - 3s), trunc(pt + 3s + 1)) per axis (Python's
    int() truncates toward zero, so a fractional point below 3s gets a
    window one pixel short); the gaussian, 1 at its centre ul + 3s, has the
    effective sigma size/4 = (6s + 1)/4.  A keypoint whose window misses
    the map leaves its map zero."""
    tmp_size = int(3 * sigma)
    eff_sigma = (2 * tmp_size + 1) / 4.0
    ul = torch.trunc(pts - tmp_size).to(torch.int32)          # [N,K,2]
    br = torch.trunc(pts + tmp_size + 1).to(torch.int32)
    centre = (ul + tmp_size).float()
    xs = torch.arange(res_w, device=pts.device)
    ys = torch.arange(res_h, device=pts.device)
    dx = xs.float() - centre[..., 0, None, None]              # [N,K,1,W]
    dy = ys.float()[:, None] - centre[..., 1, None, None]     # [N,K,H,1]
    g = torch.exp(-(dx ** 2 + dy ** 2) / (2.0 * eff_sigma ** 2))
    in_x = (xs >= ul[..., 0, None, None]) & (xs < br[..., 0, None, None])
    in_y = ((ys[:, None] >= ul[..., 1, None, None])
            & (ys[:, None] < br[..., 1, None, None]))
    on_map = ((ul[..., 0] < res_w) & (ul[..., 1] < res_h)
              & (br[..., 0] >= 0) & (br[..., 1] >= 0))
    keep = in_x & in_y & on_map[..., None, None]
    return torch.where(keep, g, torch.zeros((), device=pts.device))


def heatmap_concentration(hms):
    """Per-keypoint peak concentration: the inverse participation ratio of
    the rectified heatmap, sum(h+^2) / sum(h+)^2, in 1/pixels.  A sharp
    unimodal peak scores high; a flat or multimodal response tends toward
    1/support_area.  hms [n,K,H,W] -> [n,K] float32, 0 for all-nonpositive
    maps."""
    h = hms.float().clamp_min(0.0)
    mass = h.sum(dim=(-1, -2))
    mass2 = (h * h).sum(dim=(-1, -2))
    return torch.where(mass > 0, mass2 / mass.clamp_min(1e-12) ** 2,
                       torch.zeros_like(mass))


def decode_heatmaps(hms, pt1, pt2, inp_h: int, inp_w: int,
                    res_h: int, res_w: int):
    """Vectorized `getPrediction`: hms [n,K,H,W] float32; pt1/pt2 [n,2]
    crop corners.  Returns (preds [n,K,2] heatmap coords, preds_img [n,K,2]
    image coords, maxval [n,K,1])."""
    out = decode_peaks(hms)
    preds = out[..., :2]
    preds_img = transform_box_invert_batch(
        preds, pt1, pt2, inp_h, inp_w, res_h, res_w)
    return preds, preds_img, out[..., 2:3]
