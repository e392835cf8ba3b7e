"""The capacity-1 6D-pose pipeline on the card.

Counterpart of `betapose_tpu/eval/pipeline.py` (capacity-1 path):

    frames (uint8 NHWC) -> stretch-resize -> YOLOv3 -> best box -> expand
    -> affine crop -> FastPose heatmaps -> peak decode (CUDA kernel)
    -> capacity-1 pose-NMS -> keypoint pruning -> batched DLT + LM PnP

in three stages: detection + crop (the reference's 'dt' bucket), KPD
heatmaps ('pt') and decode + NMS + PnP ('pn').  PyTorch runs eagerly, so a
step is the three stages called in turn; nothing is compiled.  The conv
path runs in `cfg.compute_dtype` (bf16 on the card, with f32 accumulation);
box and crop coordinates, decode and PnP run in float32.

`s2d_stem=True` runs YOLO's first two layers through the exact
space-to-depth rewrite (`models/stem_s2d.py`).  Options outside this slice
raise `NotImplementedError` naming their ROADMAP slice: `det_capacity > 1`
and `host_pose_nms` (slice 2) and `net_type="hgPRM"` (slice 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from betapose_tpu_torch.core.device import resolve_device, synchronize
from betapose_tpu_torch.models import stem_s2d
from betapose_tpu_torch.ops import boxes as box_ops
from betapose_tpu_torch.ops import heatmap as hm_ops
from betapose_tpu_torch.ops import image as image_ops
from betapose_tpu_torch.ops import pnp as pnp_ops
from betapose_tpu_torch.ops import pose_nms as pnms

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class PipelineConfig:
    reso: int = 416                 # YOLO input
    inp_h: int = 320                # KPD crop
    inp_w: int = 256
    out_h: int = 80                 # KPD heatmap
    out_w: int = 64
    n_kp: int = 50
    confidence: float = 0.01        # objectness threshold (opt.py:126)
    left_keypoints: int = 50        # keypoints fed to PnP (dataloader.py:718)
    preproc: str = "stretch"        # 'stretch' | 'letterbox'
    target_class: int = 0
    compute_dtype: str = "bfloat16"  # conv-path dtype
    s2d_stem: bool = False          # exact space-to-depth YOLO stem; the
    #                               # JAX default is True (chosen on the
    #                               # TPU); the card's default waits for
    #                               # chip_smoke.py's timing of both stems
    pnp_iters: int = 12             # LM refinement steps
    pnp_robust_rounds: int = 0      # >0: trimmed-IRLS robust PnP (extension)
    pnp_score_power: float = 0.0    # >0: weight PnP points by
    #                               # clip(kp_score,0)**power (extension)
    pnp_spread_power: float = 0.0   # >0: also weight by heatmap peak
    #                               # concentration**power (extension)
    pnp_depth_prior: float = 0.0    # >0: soft LM prior pulling t_z toward
    #                               # f * kp-cloud diameter / box size
    det_capacity: int = 1           # boxes/frame; >1 is ROADMAP slice 2
    nms_thresh: float = 0.4         # greedy-NMS IoU (multi-candidate only)
    host_pose_nms: bool = False     # multi-candidate only (slice 2)
    flip_tta: bool = False          # average KPD heatmaps with the mirror
    net_type: str = "resnet101"     # FastPose resnet50/101; hgPRM: slice 3


def check_config(cfg: PipelineConfig) -> None:
    """Raise on options this slice of the port does not run."""
    if cfg.det_capacity > 1 or cfg.host_pose_nms:
        raise NotImplementedError(
            "det_capacity > 1 / host_pose_nms: the multi-candidate path is "
            "ROADMAP queue 1, slice 2")
    if cfg.net_type == "hgPRM":
        raise NotImplementedError("net_type='hgPRM' is ROADMAP slice 3")
    if cfg.net_type not in ("resnet50", "resnet101"):
        raise ValueError(f"unsupported net_type {cfg.net_type!r}")
    if cfg.preproc not in ("stretch", "letterbox"):
        raise ValueError(f"unknown preproc {cfg.preproc!r}")
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")


def make_det_stage(cfg: PipelineConfig):
    """Stage 1, detection + crop: (yolo, frames u8 [B,H,W,3]) -> boxes and
    KPD crops (the reference's DetectionLoader + DetectionProcessor)."""
    cdtype = _DTYPES[cfg.compute_dtype]

    def det_stage(yolo, frames):
        _, h0, w0, _ = frames.shape
        # pixels go straight to the compute dtype (0..255 are exact in
        # bf16); box and crop coordinates stay float32
        imgs_c = frames.to(cdtype) / 255.0
        if cfg.preproc == "stretch":
            yolo_in = image_ops.resize_bilinear_matmul(
                imgs_c, cfg.reso, cfg.reso)
            rescale = box_ops.rescale_boxes
        else:
            imgs = frames.float() / 255.0
            yolo_in = image_ops.letterbox(
                imgs * 255.0, cfg.reso, cfg.reso).to(cdtype) / 255.0
            rescale = box_ops.unletterbox_boxes
        dets = (stem_s2d.forward_with_s2d_stem(yolo, yolo_in)
                if cfg.s2d_stem else yolo(yolo_in))
        best = box_ops.best_box(dets, cfg.confidence, cfg.target_class)
        boxes = rescale(best["boxes"], w0, h0, cfg.reso)
        crops, pt1, pt2 = image_ops.crop_from_dets(
            imgs_c, boxes, cfg.inp_h, cfg.inp_w)
        return {"boxes": boxes, "obj_score": best["obj_score"],
                "det_valid": best["valid"], "crops": crops,
                "pt1": pt1, "pt2": pt2}

    return det_stage


def make_pose_stage(cfg: PipelineConfig):
    """Stage 2, KPD heatmaps: (kpd, crops) -> [B,K,H,W] float32."""

    def pose_stage(kpd, crops):
        hm = kpd(crops)
        if cfg.flip_tta:
            # mirrored forward, un-mirrored and averaged (reference
            # InferenNet; LineMod keypoints have no left/right channels)
            hm = (hm + kpd(crops.flip(2)).flip(-1)) / 2.0
        return hm.float().contiguous()

    return pose_stage


def _pnp_batch(cfg: PipelineConfig, p3, p2, cam_K, sc, spread, boxes,
               diameter):
    """PnP per cfg over a batch (the JAX `_pnp_one`, vmapped there): least
    squares (cv2.solvePnP semantics), or the robust / weighted /
    depth-prior extensions."""
    w = None
    if cfg.pnp_score_power > 0:
        w = sc.clamp_min(0.0) ** cfg.pnp_score_power
    if cfg.pnp_spread_power > 0:
        ws = spread.clamp_min(0.0) ** cfg.pnp_spread_power
        w = ws if w is None else w * ws
    z_prior, z_lambda = None, 0.0
    if cfg.pnp_depth_prior > 0:
        size_px = torch.maximum(boxes[:, 2] - boxes[:, 0],
                                boxes[:, 3] - boxes[:, 1])
        f = (cam_K[0, 0] + cam_K[1, 1]) * 0.5
        z_prior = f * diameter / size_px.clamp_min(1.0)
        z_lambda = cfg.pnp_depth_prior
    if w is not None or z_prior is not None or cfg.pnp_robust_rounds > 0:
        return pnp_ops.solve_pnp_robust(
            p3, p2, cam_K, iters=cfg.pnp_iters, rounds=cfg.pnp_robust_rounds,
            w=w, z_prior=z_prior, z_lambda=z_lambda)
    return pnp_ops.solve_pnp(p3, p2, cam_K, iters=cfg.pnp_iters)


def _kp_cloud_diameter(kp3d):
    """Max pairwise distance of the keypoint cloud [K,3]."""
    d2 = ((kp3d[:, None] - kp3d[None]) ** 2).sum(dim=-1)
    return torch.sqrt(d2.max())


def make_post_stage(cfg: PipelineConfig):
    """Stage 3: decode + pose-NMS + keypoint pruning + PnP (the reference's
    DataWriter.update chain)."""

    def post_stage(hm, det, kp3d, cam_K):
        b = hm.shape[0]
        _, preds_img, maxval = hm_ops.decode_heatmaps(
            hm, det["pt1"], det["pt2"], cfg.inp_h, cfg.inp_w,
            cfg.out_h, cfg.out_w)
        keypoints, kp_scores, proposal, nms_valid = pnms.pose_nms_single(
            det["obj_score"], preds_img, maxval)
        spread = (hm_ops.heatmap_concentration(hm)
                  if cfg.pnp_spread_power > 0 else torch.zeros_like(kp_scores))

        # keypoint pruning to left_keypoints (dataloader.py:718-724); a
        # stable descending sort breaks ties to the lower index, as
        # jax.lax.top_k does
        if cfg.left_keypoints < cfg.n_kp:
            top_sc, top_idx = torch.sort(kp_scores, dim=1, descending=True,
                                         stable=True)
            top_sc = top_sc[:, :cfg.left_keypoints]
            top_idx = top_idx[:, :cfg.left_keypoints]
            kp2d_sel = keypoints.gather(
                1, top_idx[..., None].expand(-1, -1, 2))
            kp3d_sel = kp3d[top_idx]
            sc_sel = top_sc
            spread_sel = spread.gather(1, top_idx)
        else:
            kp2d_sel = keypoints
            kp3d_sel = kp3d[None].expand(b, -1, -1)
            sc_sel = kp_scores
            spread_sel = spread

        R, t = _pnp_batch(cfg, kp3d_sel, kp2d_sel, cam_K, sc_sel, spread_sel,
                          det["boxes"], _kp_cloud_diameter(kp3d))
        return {
            "boxes": det["boxes"],                # [B,4] xyxy image coords
            "obj_score": det["obj_score"],        # [B]
            "det_valid": det["det_valid"],        # [B]
            "keypoints": keypoints,               # [B,K,2] (-0.3 offset)
            "kp_scores": kp_scores,               # [B,K]
            "proposal_score": proposal,           # [B]
            "pose_valid": det["det_valid"] & nms_valid,
            "cam_R": R,                           # [B,3,3]
            "cam_t": t,                           # [B,3]
        }

    return post_stage


def make_pose_step(cfg: PipelineConfig):
    """step(yolo, kpd, frames u8 [B,H0,W0,3] RGB, kp3d [K,3], cam_K [3,3])
    -> dict of per-frame outputs (the keys of the JAX pipeline)."""
    check_config(cfg)
    det_stage = make_det_stage(cfg)
    pose_stage = make_pose_stage(cfg)
    post_stage = make_post_stage(cfg)

    def step(yolo, kpd, frames, kp3d, cam_K):
        det = det_stage(yolo, frames)
        hm = pose_stage(kpd, det["crops"])
        return post_stage(hm, det, kp3d, cam_K)

    return step


def _prepare(model, device, dtype):
    model = model.to(device=device, dtype=dtype).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


class PosePipeline:
    """Host-side wrapper: owns the networks on the device and feeds
    batches.  device=None means CUDA and raises without it; the CPU runs
    only when asked for (device="cpu").

    yolo: a `models.yolov3.Darknet`; kpd: a `models.kpd.FastPose`.  The
    networks are moved to the device and the compute dtype as they are (the
    callers fold batch norm first, as the JAX callers do)."""

    def __init__(self, yolo, kpd, kp3d, cam_K,
                 cfg: PipelineConfig | None = None,
                 left_keypoints: int | None = None, device=None):
        self.cfg = cfg or PipelineConfig()
        if left_keypoints is not None:
            self.cfg = dataclasses.replace(
                self.cfg, left_keypoints=min(left_keypoints, self.cfg.n_kp))
        check_config(self.cfg)
        self.device = resolve_device(device)
        cdtype = _DTYPES[self.cfg.compute_dtype]
        self.yolo = _prepare(yolo, self.device, cdtype)
        self.kpd = _prepare(kpd, self.device, cdtype)
        self.kp3d = torch.as_tensor(np.asarray(kp3d), dtype=torch.float32,
                                    device=self.device)
        self.cam_K = torch.as_tensor(np.asarray(cam_K), dtype=torch.float32,
                                     device=self.device)
        self.det_stage = make_det_stage(self.cfg)
        self.pose_stage = make_pose_stage(self.cfg)
        self.post_stage = make_post_stage(self.cfg)

    def to_device(self, frames_u8):
        """uint8 frames (numpy or tensor) -> a tensor on the device; host
        frames go through pinned memory and a non-blocking copy."""
        frames = torch.as_tensor(frames_u8)
        if self.device.type == "cuda" and frames.device.type == "cpu":
            frames = frames.pin_memory()
        return frames.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def __call__(self, frames_u8):
        """frames_u8: [B,H,W,3] RGB uint8.  Returns a dict of tensors on
        the device (the work may still be queued).

        On CUDA out-of-memory the batch is split in half and retried, the
        reference's OOM fallback (`train_KPD/src/evaluation.py:95-106`)."""
        try:
            frames = self.to_device(frames_u8)
            det = self.det_stage(self.yolo, frames)
            hm = self.pose_stage(self.kpd, det["crops"])
            return self.post_stage(hm, det, self.kp3d, self.cam_K)
        except torch.cuda.OutOfMemoryError:
            if len(frames_u8) < 2:
                raise
        half = len(frames_u8) // 2
        out1 = self(frames_u8[:half])
        out2 = self(frames_u8[half:])
        return {k: torch.cat([out1[k], out2[k]]) for k in out1}

    @torch.inference_mode()
    def profiled_call(self, frames_u8, prof):
        """Like __call__, but each stage ends in a device synchronize inside
        its `prof` bucket: dt (detection + crop), pt (KPD), pn (decode,
        NMS, PnP), the reference's per-stage readout
        (`betapose_evaluate.py:132-136`)."""
        frames = self.to_device(frames_u8)
        with prof.bucket("dt"):
            det = self.det_stage(self.yolo, frames)
            synchronize(self.device)
        with prof.bucket("pt"):
            hm = self.pose_stage(self.kpd, det["crops"])
            synchronize(self.device)
        with prof.bucket("pn"):
            out = self.post_stage(hm, det, self.kp3d, self.cam_K)
            synchronize(self.device)
        return out

    def run_batches(self, frame_iter, prof=None):
        """Run over uint8 frame batches; batch i+1 is queued on the device
        before batch i's outputs are copied to the host.  Returns a list of
        dicts of numpy arrays.  prof: a `RuntimeProfile` to run each batch
        through `profiled_call` instead."""
        results = []
        pending = None
        for batch in frame_iter:
            out = self(batch) if prof is None else self.profiled_call(batch,
                                                                      prof)
            if pending is not None:
                results.append(to_numpy(pending))
            pending = out
        if pending is not None:
            results.append(to_numpy(pending))
        return results


def to_numpy(out):
    return {k: v.cpu().numpy() for k, v in out.items()}
