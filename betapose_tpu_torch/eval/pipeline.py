"""The 6D-pose pipeline on the card.

Counterpart of `betapose_tpu/eval/pipeline.py`:

    frames (uint8 NHWC) -> stretch-resize -> YOLOv3 -> best box -> expand
    -> affine crop -> FastPose heatmaps -> peak decode (CUDA kernel)
    -> capacity-1 pose-NMS -> keypoint pruning -> batched DLT + LM PnP

in three stages: detection + crop (the reference's 'dt' bucket), KPD
heatmaps ('pt') and decode + NMS + PnP ('pn').  PyTorch runs eagerly, so a
step is the three stages called in turn; nothing is compiled.  The conv
path runs in `cfg.compute_dtype` (bf16 on the card, with f32 accumulation);
box and crop coordinates, decode and PnP run in float32.  YOLO's bf16
layers keep float32 sums, bias and activation and round once, as the JAX
`_conv_layer` does (`models/yolov3.conv_bf16`).

With `det_capacity = N > 1` (the multi-candidate path, for crowded and
occluded scenes) the det stage keeps up to N greedy-NMS'd boxes per frame
and crops each, the KPD and the decode kernel run on B*N crops, and the
post stage clusters each frame's candidates with the fixed-trip device
pose-NMS (`ops/pose_nms.pose_nms_device`) before PnP.  `host_pose_nms=True`
instead decodes the candidates on the device and clusters them on the host
with the reference's loop (`ops/pose_nms.pose_nms`), then runs one batched
PnP.  Every mode returns the same per-frame keys.

`s2d_stem=True` runs YOLO's first two layers through the exact
space-to-depth rewrite (`models/stem_s2d.py`).  `net_type="hgPRM"` serves
PyraNet (`models/hgprm.py`) in the pose stage instead of FastPose: in
float32 whatever `compute_dtype` says (flip-TTA included), on the det
stage's crops cast to float32, as the JAX package does; on the card its
float32 convs and matmuls run with TF32 off (`core/device.py`).
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
    det_capacity: int = 1           # boxes/frame; >1 = multi-candidate mode
    nms_thresh: float = 0.4         # greedy-NMS IoU (multi-candidate only)
    host_pose_nms: bool = False     # multi-candidate only: True = the
    #                               # reference's clustering loop on the
    #                               # host; False = the fixed-trip device
    #                               # pose-NMS
    flip_tta: bool = False          # average KPD heatmaps with the mirror
    net_type: str = "resnet101"     # FastPose resnet50/101, or hgPRM
    #                               # (PyraNet, float32)


def check_config(cfg: PipelineConfig) -> None:
    """Raise on options the port does not run, or that are malformed."""
    if cfg.det_capacity < 1:
        raise ValueError(f"det_capacity must be >= 1, got {cfg.det_capacity}")
    if cfg.net_type not in ("resnet50", "resnet101", "hgPRM"):
        raise ValueError(f"unsupported net_type {cfg.net_type!r}")
    if cfg.preproc not in ("stretch", "letterbox"):
        raise ValueError(f"unknown preproc {cfg.preproc!r}")
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")


def make_det_stage(cfg: PipelineConfig):
    """Stage 1, detection + crop: (yolo, frames u8 [B,H,W,3]) -> boxes and
    KPD crops (the reference's DetectionLoader + DetectionProcessor).
    Capacity 1: boxes [B,4], crops [B,...]; capacity N: boxes, obj_score
    and det_valid [B,N,...], crops and pt1/pt2 [B*N,...]."""
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
        if cfg.det_capacity > 1:
            # up to N greedy-NMS'd boxes per frame, each cropped; the crops
            # go on as [B*N,...], each frame's N boxes in a row
            sel = box_ops.top_boxes(
                dets, cfg.confidence, cfg.target_class,
                capacity=cfg.det_capacity, nms_thresh=cfg.nms_thresh,
                prefilter=max(64, cfg.det_capacity * 8))
        else:
            sel = box_ops.best_box(dets, cfg.confidence, cfg.target_class)
        boxes = rescale(sel["boxes"], w0, h0, cfg.reso)
        crops, pt1, pt2 = image_ops.crop_from_dets(
            imgs_c, boxes, cfg.inp_h, cfg.inp_w)
        if cfg.det_capacity > 1:
            crops = crops.flatten(0, 1)
            pt1, pt2 = pt1.flatten(0, 1), pt2.flatten(0, 1)
        return {"boxes": boxes, "obj_score": sel["obj_score"],
                "det_valid": sel["valid"], "crops": crops,
                "pt1": pt1, "pt2": pt2}

    return det_stage


def make_pose_stage(cfg: PipelineConfig):
    """Stage 2, KPD heatmaps: (kpd, crops) -> [B,K,H,W] float32."""

    def pose_stage(kpd, crops):
        if cfg.net_type == "hgPRM":
            crops = crops.float()   # PyraNet runs float32 (JAX pipeline)
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


def _prune_keypoints(cfg: PipelineConfig, kp, sc, spread, kp3d):
    """Keypoint pruning to cfg.left_keypoints (dataloader.py:718-724):
    (kp2d_sel, kp3d_sel, sc_sel, spread_sel).  A stable descending sort
    breaks ties to the lower index, as jax.lax.top_k does."""
    if cfg.left_keypoints >= cfg.n_kp:
        return kp, kp3d[None].expand(kp.shape[0], -1, -1), sc, spread
    top_sc, top_idx = torch.sort(sc, dim=1, descending=True, stable=True)
    top_idx = top_idx[:, :cfg.left_keypoints]
    return (kp.gather(1, top_idx[..., None].expand(-1, -1, 2)),
            kp3d[top_idx], top_sc[:, :cfg.left_keypoints],
            spread.gather(1, top_idx))


def make_post_stage(cfg: PipelineConfig):
    """Stage 3: decode + pose-NMS + keypoint pruning + PnP (the reference's
    DataWriter.update chain)."""

    def post_stage(hm, det, kp3d, cam_K):
        _, preds_img, maxval = hm_ops.decode_heatmaps(
            hm, det["pt1"], det["pt2"], cfg.inp_h, cfg.inp_w,
            cfg.out_h, cfg.out_w)
        keypoints, kp_scores, proposal, nms_valid = pnms.pose_nms_single(
            det["obj_score"], preds_img, maxval)
        spread = (hm_ops.heatmap_concentration(hm)
                  if cfg.pnp_spread_power > 0 else torch.zeros_like(kp_scores))
        kp2d_sel, kp3d_sel, sc_sel, spread_sel = _prune_keypoints(
            cfg, keypoints, kp_scores, spread, kp3d)
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


def make_candidates_decode_stage(cfg: PipelineConfig):
    """Decode sub-stage of the multi-candidate path: heatmaps [B*N,K,H,W]
    and the det stage's output -> per-candidate keypoints [B,N,...]."""

    def decode_stage(hm, det):
        _, preds_img, maxval = hm_ops.decode_heatmaps(
            hm, det["pt1"], det["pt2"], cfg.inp_h, cfg.inp_w,
            cfg.out_h, cfg.out_w)
        b, n = det["boxes"].shape[:2]
        return {
            "boxes": det["boxes"],                        # [B,N,4]
            "obj_score": det["obj_score"],                # [B,N]
            "det_valid": det["det_valid"],                # [B,N]
            "kp2d": preds_img.reshape(b, n, cfg.n_kp, 2),
            "kp_scores": maxval.reshape(b, n, cfg.n_kp),
        }

    return decode_stage


def make_multi_post_stage(cfg: PipelineConfig):
    """Stage 3 for det_capacity > 1, device mode: decode + device pose-NMS
    over each frame's N candidates + keypoint pruning + PnP.  The
    reference's clustering loop (`pPose_nms.py:58-83`) is bounded by the
    capacity, so it runs as N fixed trips (`ops/pose_nms.pose_nms_device`).
    The output keys and shapes are the capacity-1 stage's; boxes and
    obj_score are the winning candidate's."""
    decode_stage = make_candidates_decode_stage(cfg)

    def post_stage(hm, det, kp3d, cam_K):
        cand = decode_stage(hm, det)
        b, n = cand["boxes"].shape[:2]
        # the spread statistic rides the pose-NMS merge like the coordinates
        extra = (hm_ops.heatmap_concentration(hm).reshape(b, n, cfg.n_kp)
                 if cfg.pnp_spread_power > 0 else None)
        kp, sc, proposal, pick_box, pick_obj, nms_valid, *merged = \
            pnms.pose_nms_device(cand["boxes"], cand["obj_score"],
                                 cand["kp2d"], cand["kp_scores"],
                                 cand["det_valid"], extra=extra)
        spread = merged[0] if merged else torch.zeros_like(sc)
        kp2d_sel, kp3d_sel, sc_sel, spread_sel = _prune_keypoints(
            cfg, kp, sc, spread, kp3d)
        R, t = _pnp_batch(cfg, kp3d_sel, kp2d_sel, cam_K, sc_sel, spread_sel,
                          pick_box, _kp_cloud_diameter(kp3d))
        det_any = cand["det_valid"].any(dim=1)
        return {
            "boxes": pick_box,                    # the winner's box
            "obj_score": pick_obj,
            "det_valid": det_any,                 # any candidate
            "keypoints": kp,
            "kp_scores": sc,
            "proposal_score": proposal,
            "pose_valid": det_any & nms_valid,
            "cam_R": R,
            "cam_t": t,
        }

    return post_stage


def make_pose_step(cfg: PipelineConfig):
    """step(yolo, kpd, frames u8 [B,H0,W0,3] RGB, kp3d [K,3], cam_K [3,3])
    -> dict of per-frame outputs (the keys of the JAX pipeline).  With
    det_capacity > 1 the post stage runs the device pose-NMS over each
    frame's candidates."""
    check_config(cfg)
    det_stage = make_det_stage(cfg)
    pose_stage = make_pose_stage(cfg)
    post_stage = (make_multi_post_stage(cfg) if cfg.det_capacity > 1
                  else make_post_stage(cfg))

    def step(yolo, kpd, frames, kp3d, cam_K):
        det = det_stage(yolo, frames)
        hm = pose_stage(kpd, det["crops"])
        return post_stage(hm, det, kp3d, cam_K)

    return step


def make_candidates_step(cfg: PipelineConfig):
    """The device part of the host pose-NMS mode (det_capacity > 1):
    step(yolo, kpd, frames) -> per-candidate decoded keypoints [B,N,...].
    It stops before pose-NMS, whose clustering loop
    (`pPose_nms.py:24-122`) then runs on the host (`ops/pose_nms.pose_nms`),
    as the reference's DataWriter does."""
    check_config(cfg)
    det_stage = make_det_stage(cfg)
    pose_stage = make_pose_stage(cfg)
    decode_stage = make_candidates_decode_stage(cfg)

    def step(yolo, kpd, frames):
        det = det_stage(yolo, frames)
        hm = pose_stage(kpd, det["crops"])
        return decode_stage(hm, det)

    return step


def _prepare(model, device, dtype=None):
    model = model.to(device=device, dtype=dtype).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


class PosePipeline:
    """Host-side wrapper: owns the networks on the device and feeds
    batches.  device=None means CUDA and raises without it; the CPU runs
    only when asked for (device="cpu").

    yolo: a `models.yolov3.Darknet`; kpd: a `models.kpd.FastPose`, or a
    `models.hgprm.PyraNet` with cfg.net_type="hgPRM".  The networks are
    moved to the device as they are (the callers fold FastPose's and YOLO's
    batch norms first, as the JAX callers do).  FastPose is cast to the
    compute dtype; PyraNet stays float32; YOLO keeps float32 parameters and
    runs in the dtype of its input, the compute dtype (its bf16 layers
    round their weights to bf16 themselves, `models/yolov3.ConvLayer`).

    A step is a device part (`_run_device`: the whole step, or in host
    pose-NMS mode the decoded candidates) and a host part (`_post_device`:
    nothing, or the host clustering and one batched PnP)."""

    def __init__(self, yolo, kpd, kp3d, cam_K,
                 cfg: PipelineConfig | None = None,
                 left_keypoints: int | None = None, device=None):
        """left_keypoints: overrides cfg.left_keypoints, the occlusion
        eval's `--left_keypoints` PnP pruning knob
        (`occlusion_betapose_evaluate.py:139`, `dataloader.py:718-724`)."""
        self.cfg = cfg or PipelineConfig()
        if left_keypoints is not None:
            self.cfg = dataclasses.replace(
                self.cfg, left_keypoints=min(left_keypoints, self.cfg.n_kp))
        check_config(self.cfg)
        self.device = resolve_device(device)
        self.yolo = _prepare(yolo, self.device)
        self.kpd = _prepare(kpd, self.device,
                            torch.float32 if self.cfg.net_type == "hgPRM"
                            else _DTYPES[self.cfg.compute_dtype])
        self.kp3d = torch.as_tensor(np.asarray(kp3d), dtype=torch.float32,
                                    device=self.device)
        self.cam_K = torch.as_tensor(np.asarray(cam_K), dtype=torch.float32,
                                     device=self.device)
        self.host_mode = self.cfg.det_capacity > 1 and self.cfg.host_pose_nms
        self.det_stage = make_det_stage(self.cfg)
        self.pose_stage = make_pose_stage(self.cfg)
        self.post_stage = (make_multi_post_stage(self.cfg)
                           if self.cfg.det_capacity > 1
                           else make_post_stage(self.cfg))
        self.decode_stage = make_candidates_decode_stage(self.cfg)

    def to_device(self, frames_u8):
        """uint8 frames (numpy or tensor) -> a tensor on the device; host
        frames go through pinned memory and a non-blocking copy."""
        frames = torch.as_tensor(frames_u8)
        if self.device.type == "cuda" and frames.device.type == "cpu":
            frames = frames.pin_memory()
        return frames.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def __call__(self, frames_u8):
        """frames_u8: [B,H,W,3] RGB uint8.  Returns a dict of per-frame
        tensors on the device (the work may still be queued)."""
        return self._post_device(self._run_device(frames_u8))

    def _device_outputs(self, hm, det):
        if self.host_mode:
            return self.decode_stage(hm, det)
        return self.post_stage(hm, det, self.kp3d, self.cam_K)

    @torch.inference_mode()
    def _run_device(self, frames_u8):
        """Queue the device part of a step.  On CUDA out-of-memory the batch
        is split in half and retried, the reference's OOM fallback
        (`train_KPD/src/evaluation.py:95-106`)."""
        try:
            frames = self.to_device(frames_u8)
            det = self.det_stage(self.yolo, frames)
            hm = self.pose_stage(self.kpd, det["crops"])
            return self._device_outputs(hm, det)
        except torch.cuda.OutOfMemoryError:
            if len(frames_u8) < 2:
                raise
        half = len(frames_u8) // 2
        out1 = self._run_device(frames_u8[:half])
        out2 = self._run_device(frames_u8[half:])
        return {k: torch.cat([out1[k], out2[k]]) for k in out1}

    @torch.inference_mode()
    def _post_device(self, out):
        """The host part of a step: identity, or the host pose-NMS."""
        return self._host_pose_nms(out) if self.host_mode else out

    def _host_pose_nms(self, cand):
        """Host mode's post stage: the reference's pose-NMS loop per frame
        over its valid candidates (`pPose_nms.py` through
        DataWriter.update), the best surviving proposal, keypoint pruning,
        then one batched PnP on the device.  The outputs are attributed to
        the winning candidate (its own box and objectness); det_valid is
        any of the frame's candidates.  The output keys are the device
        mode's."""
        if self.cfg.pnp_spread_power > 0:
            # the host loop does not carry the heatmaps; refuse rather than
            # silently drop the requested weighting
            raise ValueError(
                "pnp_spread_power requires the device pose-NMS "
                "(drop --host_pose_nms)")
        cand = to_numpy(cand)
        b = cand["boxes"].shape[0]
        k_all = self.cfg.n_kp
        left = min(self.cfg.left_keypoints, k_all)
        kp3d = self.kp3d.cpu().numpy()

        boxes = np.zeros((b, 4), np.float32)
        obj_score = np.zeros((b,), np.float32)
        keypoints = np.zeros((b, k_all, 2), np.float32)
        kp_scores = np.zeros((b, k_all), np.float32)
        proposal = np.zeros((b,), np.float32)
        valid = np.zeros((b,), bool)
        kp2d_sel = np.zeros((b, left, 2), np.float32)
        kp3d_sel = np.tile(kp3d[None, :left], (b, 1, 1)).astype(np.float32)
        sc_sel = np.ones((b, left), np.float32)

        for i in range(b):
            v = cand["det_valid"][i]
            if not v.any():
                continue
            results = pnms.pose_nms(
                cand["boxes"][i][v], cand["obj_score"][i][v],
                cand["kp2d"][i][v], cand["kp_scores"][i][v][..., None])
            if not results:
                continue
            best = max(results, key=lambda r: r["proposal_score"])
            kp = np.asarray(best["keypoints"], np.float32)
            sc = np.asarray(best["kp_score"], np.float32)[:, 0]
            # the picked candidate's own box and objectness (not the
            # reference's bboxes[0] quirk, not the max over candidates)
            boxes[i] = best["pick_bbox"]
            obj_score[i] = best["bbox_score"]
            keypoints[i], kp_scores[i] = kp, sc
            proposal[i] = best["proposal_score"]
            valid[i] = True
            top = np.argsort(-sc, kind="stable")[:left]
            kp2d_sel[i] = kp[top]
            kp3d_sel[i] = kp3d[top]
            sc_sel[i] = sc[top]

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        R, t = _pnp_batch(self.cfg, dev(kp3d_sel), dev(kp2d_sel), self.cam_K,
                          dev(sc_sel), dev(np.zeros_like(sc_sel)), dev(boxes),
                          _kp_cloud_diameter(self.kp3d))
        return {
            "boxes": dev(boxes),
            "obj_score": dev(obj_score),
            "det_valid": dev(cand["det_valid"].any(axis=1)),
            "keypoints": dev(keypoints),
            "kp_scores": dev(kp_scores),
            "proposal_score": dev(proposal),
            "pose_valid": dev(valid),
            "cam_R": R,
            "cam_t": t,
        }

    @torch.inference_mode()
    def profiled_call(self, frames_u8, prof):
        """Like __call__, but each stage ends in a device synchronize inside
        its `prof` bucket: dt (detection + crop), pt (KPD), pn (decode,
        NMS, PnP; in host mode the host pose-NMS too), the reference's
        per-stage readout (`betapose_evaluate.py:132-136`)."""
        frames = self.to_device(frames_u8)
        with prof.bucket("dt"):
            det = self.det_stage(self.yolo, frames)
            synchronize(self.device)
        with prof.bucket("pt"):
            hm = self.pose_stage(self.kpd, det["crops"])
            synchronize(self.device)
        with prof.bucket("pn"):
            out = self._post_device(self._device_outputs(hm, det))
            synchronize(self.device)
        return out

    def run_batches(self, frame_iter, prof=None):
        """Run over uint8 frame batches; batch i+1's device part is queued
        before batch i is finished on the host, so in host pose-NMS mode
        the host clustering of batch i overlaps the device work of batch
        i+1.  Returns a list of dicts of numpy arrays.  prof: a
        `RuntimeProfile` to run each batch through `profiled_call`
        instead (synchronized, no overlap)."""
        results = []
        pending = None
        for batch in frame_iter:
            if prof is not None:
                results.append(to_numpy(self.profiled_call(batch, prof)))
                continue
            out = self._run_device(batch)
            if pending is not None:
                results.append(to_numpy(self._post_device(pending)))
            pending = out
        if pending is not None:
            results.append(to_numpy(self._post_device(pending)))
        return results


def to_numpy(out):
    return {k: v.cpu().numpy() for k, v in out.items()}
