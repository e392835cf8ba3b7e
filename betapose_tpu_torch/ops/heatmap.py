"""Heatmap peak decoding back to image coordinates, and the peak
concentration statistic.

Counterpart of `betapose_tpu/ops/heatmap.py` (reference `getPrediction`,
`KPD/src/utils/eval.py:113-147`).  The peak stage is
`ops/kernels/heatmap_decode.decode_peaks`: the CUDA kernel for a tensor on
the card, its plain version for a tensor on the CPU.  Target rendering
(`draw_gaussian_batch`) belongs to KPD training (ROADMAP slice 4).
"""

from __future__ import annotations

import torch

from betapose_tpu_torch.ops.image import transform_box_invert_batch
from betapose_tpu_torch.ops.kernels.heatmap_decode import decode_peaks


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
