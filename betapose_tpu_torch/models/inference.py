"""KPD inference wrappers, parity with `KPD/src/main_fast_inference.py`.

Counterpart of `betapose_tpu/models/inference.py`.  `InferenNetFast`
mirrors `InferenNet_fast:26-46`: load the per-object checkpoint through the
hard-coded name table, run FastPose, narrow the output to the first
nClasses channels.  `InferenNet` is the flip-TTA variant the reference
names but never ships (betapose_evaluate.py:128 imports a class that does
not exist): the mean of the predictions on the crop and on its horizontal
mirror, un-mirrored (LineMod keypoints have no left/right channels, so no
channel swap; flipRef is empty, `dataloader.py:790`).

A missing checkpoint falls back to a seeded random init, as in the JAX
package.  Inputs are NHWC crops [B,H,W,3]; outputs are the port's heatmap
layout [B,nClasses,H/4,W/4] (the JAX wrappers return NHWC).  The network
runs in float32 on `device` (None: CUDA, which raises without a card).
"""

from __future__ import annotations

import os

import torch

from betapose_tpu_torch.core import checkpoint as ckpt
from betapose_tpu_torch.core.device import resolve_device
from betapose_tpu_torch.models import kpd as kpd_mod


class InferenNetFast:
    def __init__(self, kernel_size=None, obj_id: int = 1, dataset=None,
                 n_classes: int = 50, weights_path: str | None = None,
                 model_base: str = "./exp/final_model",
                 arch: str = "resnet101", device=None):
        self.device = resolve_device(device)
        path = weights_path or ckpt.default_kpd_path(obj_id, model_base)
        if os.path.exists(path):
            print("Loading KPD Model from", path)
            model = ckpt.load_kpd_checkpoint(path, n_classes, arch)
        else:
            print(f"WARNING: KPD checkpoint {path} missing; random init")
            model = kpd_mod.FastPose(n_classes, arch,
                                     torch.Generator().manual_seed(0))
        self.model = model.to(self.device).eval()
        self.n_classes = n_classes

    def _fwd(self, x):
        with torch.inference_mode():
            return self.model(torch.as_tensor(x, dtype=torch.float32,
                                              device=self.device))

    def __call__(self, x):
        """x: [B,H,W,3] normalized crops -> [B,nClasses,h,w] heatmaps."""
        return self._fwd(x)[:, :self.n_classes]


class InferenNet(InferenNetFast):
    """Flip test-time-augmented variant."""

    def __call__(self, x):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        out = (self._fwd(x) + self._fwd(x.flip(2)).flip(-1)) / 2.0
        return out[:, :self.n_classes]
