"""Full-system self-test on the card: synthetic scenes -> annotate -> train
YOLO + KPD -> the pose pipeline -> pose metrics.

Counterpart of `betapose_tpu/tools/selftest.py`.  Every stage of the
system runs end to end with no external data:

1. render a coloured cube at random poses into LineMod-sized frames
   (`geometry/renderer.py`, numpy, on the host);
2. designate keypoints (cube surface points) and annotate their 2D labels
   with the annotator's exact projection;
3. train a small YOLO on the rendered frames (darknet's loss, crop-jitter
   and HSV augmentation on the device, `train/yolo_train.py`) and a KPD
   (FastPose-resnet50, or PyraNet with `net_type="hgPRM"`) on the crops
   (masked MSE, DPG augmentation on the device, `train/kpd_train.py`);
4. run `PosePipeline` (detect -> crop -> KPD -> the peak-decode kernel ->
   PnP) on held-out frames and grade ADD / 2D error against the known
   poses, with the reference's ADD < 0.1 * diameter bar.

The frame pools stay uint8 on the device and are indexed per batch; the
host numpy `rng` is consumed in the JAX package's order (scenes, then the
YOLO batches, then the KPD batches), so a seed renders the same scenes
and picks the same batch indices in both packages.  The augmentation
draws come from `torch.Generator`s on the device, so the trained weights
are not the JAX package's.  The training loops read no value back: the
loss is read once, after each loop.

`params_dir` caches the trained weights (`yolo.weights` in darknet's
layout, `kpd.npz` in the JAX package's param-tree layout) beside a
`config.json` fingerprint; both packages write and read the same files.

Run: python -m betapose_tpu_torch.tools.selftest [--slow|--occlusion]
     [--netType hgPRM] [--params_dir D] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from betapose_tpu_torch.core import checkpoint as ckpt
from betapose_tpu_torch.core.device import resolve_device
from betapose_tpu_torch.data import sixd as sixd_mod
from betapose_tpu_torch.eval.pipeline import (PipelineConfig, PosePipeline,
                                              to_numpy)
from betapose_tpu_torch.geometry import metrics
from betapose_tpu_torch.geometry.renderer import Renderer
from betapose_tpu_torch.geometry.utils import get_bbox_from_mask
from betapose_tpu_torch.models import hgprm
from betapose_tpu_torch.models import kpd as kpd_mod
from betapose_tpu_torch.models import yolov3 as yolo_mod
from betapose_tpu_torch.tools.annotator import annotate_frame_exact
from betapose_tpu_torch.train import kpd_train, yolo_train
from betapose_tpu_torch.train.augment import DRAWS as augment_draws
from betapose_tpu_torch.train.augment import AugmentConfig, augment_batch

CAM_K = sixd_mod.LINEMOD_CAM_K

# Cache epoch: bump whenever a CODE change alters training semantics
# without moving any fingerprint knob.  Caches stamped with an older epoch
# (or none) hard-refuse to reload instead of producing a stale-weights
# number.  The JAX package's epoch: a cache crosses between the packages.
#   v2: post bf16-default + augment refactor.
#   v3: exact-identity KPD annotation (annotate_frame_exact).
CACHE_VERSION = 3

YOLO_CFG = """
[net]
width={reso}
height={reso}

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=64
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=64
size=3
stride=1
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=18
activation=linear

[yolo]
mask = 0,1,2
anchors = 24,24,  40,40,  64,64
classes=1
num=3
ignore_thresh = .7
"""


class CubeModel:
    """Solid cube with distinctly-colored faces (each face split into a
    bright and a dark triangle so in-plane orientation is also readable) —
    a pose-learnable toy object for the self-test."""

    def __init__(self, half=0.04, seed=0, face_colors=None):
        rng = np.random.default_rng(seed)
        c = np.array([[x, y, z] for x in (-half, half)
                      for y in (-half, half) for z in (-half, half)])
        # faces as corner-index quads (x-, x+, y-, y+, z-, z+)
        quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
                 (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
        if face_colors is None:
            face_colors = np.array([
                [0.9, 0.2, 0.2], [0.2, 0.9, 0.2], [0.2, 0.3, 0.9],
                [0.9, 0.9, 0.2], [0.9, 0.3, 0.9], [0.2, 0.9, 0.9]])
        face_colors = np.asarray(face_colors)
        verts, cols, tris = [], [], []
        for qi, q in enumerate(quads):
            base = len(verts)
            for vi in q:
                verts.append(c[vi])
            col = face_colors[qi]
            cols.extend([col, col, col, col])
            tris.append([base, base + 1, base + 2])       # bright tri
            tris.append([base, base + 2, base + 3])       # (shading differs)
        self.vertices = np.asarray(verts)
        self.colors = np.asarray(cols)
        self.faces = np.asarray(tris, int)
        self.half = half


def distractor_model():
    """Occluder for the occlusion tier: a smaller cube in drab gray/brown
    tones (visually distinct from every target face color) — the synthetic
    analog of Occlusion-LineMod's foreground clutter."""
    drab = np.array([[0.45, 0.40, 0.35], [0.35, 0.30, 0.28],
                     [0.50, 0.45, 0.38], [0.30, 0.28, 0.25],
                     [0.42, 0.38, 0.33], [0.38, 0.33, 0.30]])
    return CubeModel(half=0.028, seed=1, face_colors=drab)


def make_scene(rng, model, z_range=(0.55, 0.8), occluder=None,
               occl_frac=(0.15, 0.5), kp3d=None):
    """kp3d: when given, ALSO return a (K,) per-keypoint visibility array
    (1 = visible, 0 = hidden behind the occluder) — the training signal
    for occlusion-aware KPD supervision (train/augment.py kp_vis)."""
    # LineMod-like viewpoint coverage: full in-plane rotation, limited tilt
    # (the real benchmark's views live on the upper hemisphere; a toy
    # training set can't cover all of SO(3))
    ang = np.array([rng.uniform(-0.8, 0.8), rng.uniform(-0.8, 0.8),
                    rng.uniform(0, 2 * np.pi)])

    def rot(a, axis):
        c, s = np.cos(a), np.sin(a)
        m = np.eye(3)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
        return m

    R = rot(ang[0], 0) @ rot(ang[1], 1) @ rot(ang[2], 2)
    t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.08, 0.08),
                  rng.uniform(*z_range)])
    pose = np.eye(4)
    pose[:3, :3] = R
    pose[:3, 3] = t

    r = Renderer(size=(640, 480), cam=CAM_K)
    r.draw_model(model, pose)
    rgb, depth = r.finish()
    mask = depth > 0
    xmin, xmax, ymin, ymax = get_bbox_from_mask(mask)
    frame = (rng.random((480, 640, 3)) * 0.25 * 255).astype(np.uint8)
    frame[mask] = np.clip(rgb[mask] * 255, 0, 255).astype(np.uint8)
    bbox = [xmin, ymin, xmax, ymax]

    kp_vis = None if kp3d is None else np.ones(len(kp3d), np.float32)
    if occluder is not None:
        # foreground distractor rendered into its OWN z-buffer, composed by
        # depth comparison (no re-render per retry); retry offsets until
        # it hides occl_frac of the target's visible pixels — the
        # Occlusion-LineMod regime.  GT bbox/keypoints stay those of the
        # FULL object (reference trains/evals with full GT under occlusion)
        tgt_area = max(int(mask.sum()), 1)
        for _ in range(10):
            o_pose = np.eye(4)
            o_ang = rng.uniform(0, 2 * np.pi, 3)
            o_pose[:3, :3] = (rot(o_ang[0], 0) @ rot(o_ang[1], 1)
                              @ rot(o_ang[2], 2))
            side = rng.uniform(0, 2 * np.pi)
            off = rng.uniform(0.25, 0.8) * model.half
            o_pose[:3, 3] = t + [np.cos(side) * (model.half + off) * 0.9,
                                 np.sin(side) * (model.half + off) * 0.9,
                                 -rng.uniform(0.06, 0.12)]
            ro = Renderer(size=(640, 480), cam=CAM_K)
            ro.draw_model(occluder, o_pose)
            rgb_o, depth_o = ro.finish()
            omask = depth_o > 0
            wins = omask & (~mask | (depth_o < depth))
            frac = float((wins & mask).sum()) / tgt_area
            if occl_frac[0] <= frac <= occl_frac[1]:
                frame[wins] = np.clip(rgb_o[wins] * 255, 0,
                                      255).astype(np.uint8)
                if kp3d is not None:
                    # keypoint hidden iff the occluder's depth at its
                    # projected pixel is in front of the keypoint
                    kc = kp3d @ pose[:3, :3].T + pose[:3, 3]
                    u = np.clip((CAM_K[0, 0] * kc[:, 0] / kc[:, 2]
                                 + CAM_K[0, 2]).round().astype(int),
                                0, 639)
                    v = np.clip((CAM_K[1, 1] * kc[:, 1] / kc[:, 2]
                                 + CAM_K[1, 2]).round().astype(int),
                                0, 479)
                    hidden = omask[v, u] & (depth_o[v, u]
                                            < kc[:, 2] - 1e-4)
                    kp_vis = (~hidden).astype(np.float32)
                break
    if kp3d is not None:
        return frame, pose, bbox, kp_vis
    return frame, pose, bbox


def cube_keypoints(model, n_kp):
    """The designated keypoints: the 8 corners, the 6 face centers, then
    the 12 edge midpoints (well-spread distinct 3D points, as a SIFT
    designator would produce), the first n_kp of them."""
    h = model.half
    corners = np.array([[x, y, z] for x in (-h, h) for y in (-h, h)
                        for z in (-h, h)])
    centers = np.array([[-h, 0, 0], [h, 0, 0], [0, -h, 0], [0, h, 0],
                        [0, 0, -h], [0, 0, h]])
    edge_mids = []
    for i in range(8):
        for j in range(i + 1, 8):
            if np.sum(np.abs(corners[i] - corners[j]) > 1e-9) == 1:
                edge_mids.append((corners[i] + corners[j]) / 2)
    return np.concatenate([corners, centers, np.asarray(edge_mids)])[:n_kp]


def check_params_dir(params_dir, fp, epoch_key="cache_version",
                     what="params_dir"):
    """Write the fingerprint `fp` to params_dir/config.json, or refuse a
    cache whose fingerprint differs (a cache written under one tier or
    config must not be misloaded under another; shapes may coincide).
    With `epoch_key`, an older cache epoch is refused first, by name."""
    os.makedirs(params_dir, exist_ok=True)
    fp_path = os.path.join(params_dir, "config.json")
    if not os.path.exists(fp_path):
        with open(fp_path, "w") as f:
            json.dump(fp, f)
        return
    with open(fp_path) as f:
        on_disk = json.load(f)
    if epoch_key and on_disk.get(epoch_key) != fp[epoch_key]:
        raise ValueError(
            f"{what} {params_dir} was trained under cache epoch "
            f"{on_disk.get(epoch_key, 1)} but the code is at epoch "
            f"{fp[epoch_key]}: training semantics changed since these "
            "weights were written — delete the cache (or use a fresh "
            "--params_dir)")
    if on_disk != fp:
        raise ValueError(
            f"{what} {params_dir} was trained with a different config: "
            f"cached {on_disk} vs requested {fp} — use a fresh "
            "--params_dir or delete the cache")


def resolved_precision(train_precision):
    """The train precision a run uses: the given one or the default
    (bfloat16, as in the JAX package)."""
    return train_precision or kpd_train.DEFAULT_TRAIN_PRECISION


def load_draws(path, names, device):
    """The replayed draws of a training loop ({name: [iters, batch, ...]}
    on `device`) from an .npz, or None without a path."""
    if not path:
        return None
    with np.load(path) as z:
        return {k: torch.as_tensor(z[k], device=device) for k in names}


def batch_indices(rng, n, batch, iters, device):
    """The per-iteration batch indices of a training loop, drawn from the
    host `rng` in loop order (the draws of `iters` successive
    `rng.integers(0, n, batch)` calls) and put on the device at once, so
    the loop indexes its device pool without a host round trip."""
    sel = np.stack([rng.integers(0, n, batch) for _ in range(iters)]) \
        if iters > 0 else np.zeros((0, batch), np.int64)
    return torch.as_tensor(sel, device=device)


def _mark(report, key, t0):
    if report is not None:
        report[key] = time.perf_counter() - t0


def run_selftest(n_frames=60, n_eval=8, yolo_iters=250, kpd_iters=1500,
                 reso=192, inp_h=128, inp_w=96, n_kp=12, seed=0,
                 add_dpg=False, kpd_finetune_iters=0, kpd_batch=8,
                 z_range=(0.55, 0.8), left_keypoints=None, params_dir=None,
                 pnp_robust_rounds=0, occlusion=False, det_capacity=1,
                 pnp_score_power=0.0, train_precision=None,
                 net_type="resnet50", verbose=True, device=None,
                 report=None, step_hook=None, eval_hook=None,
                 yolo_init=None, yolo_draws=None, kpd_init=None,
                 kpd_draws=None):
    """Returns the stats dict of the JAX `run_selftest`.

    params_dir: when set, trained weights are saved there (yolo.weights
    darknet-format + kpd.npz param tree) and reloaded on the next run
    instead of retraining.  left_keypoints: PnP pruning (defaults to all
    n_kp).

    occlusion=True is the Occlusion-LineMod-shaped hard tier: a drab
    foreground distractor hides 15-50% of the target in EVERY eval frame
    (and half the train frames); pair with det_capacity>1 so the
    multi-candidate pose-NMS path sees learned heatmaps under clutter.

    net_type: FastPose 'resnet50' (the default tier) or 'hgPRM' (PyraNet,
    intermediate supervision + post-hoc BN calibration; heatmap dims inp/4
    must divide by 16).

    device: None means CUDA (raises without it); "cpu" only when asked.
    report: a dict to fill with the wall times of the stages ("render_s",
    "yolo_s", "kpd_s", "finetune_s", "eval_s", each ending when the
    stage's result is on the host).  step_hook(stage, it): called after
    each training step of stage "yolo", "kpd" or "kpd_finetune".
    eval_hook(pipe, eval_frames): called after the eval with its
    pipeline and frames, as in `tools/sweep.run_sweep`.

    yolo_init: a darknet .weights file the detector starts training from,
    in place of the seeded init (another package's init, for one).
    yolo_draws: an .npz of the detector loop's augmentation draws, one
    array [yolo_iters, 16] per name of `train/yolo_train.DRAWS`, replayed
    in place of the loop's generator.  kpd_init, kpd_draws: the same for
    the KPD loop (a checkpoint `core/checkpoint.load_kpd_checkpoint`
    reads; arrays [kpd_iters, kpd_batch, ...] per name of
    `train/augment.DRAWS`)."""
    if net_type not in ("resnet50", "hgPRM"):
        raise ValueError(f"unsupported selftest net_type {net_type!r}")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    model = CubeModel()
    occluder = distractor_model() if occlusion else None
    kp3d = cube_keypoints(model, n_kp)
    precision = resolved_precision(train_precision)

    ypath = os.path.join(params_dir, "yolo.weights") if params_dir else None
    kpath = os.path.join(params_dir, "kpd.npz") if params_dir else None
    if params_dir:
        fp = {"cache_version": CACHE_VERSION,
              "n_frames": n_frames, "reso": reso, "inp_h": inp_h,
              "inp_w": inp_w, "n_kp": n_kp, "seed": seed,
              "z_range": list(z_range),
              "yolo_iters": yolo_iters, "kpd_iters": kpd_iters,
              "kpd_finetune_iters": kpd_finetune_iters,
              "kpd_batch": kpd_batch, "add_dpg": add_dpg,
              "occlusion": occlusion}
        # non-default precision changes training numerics -> distinct
        # cache; omitted for float32 so pre-existing caches stay valid
        if precision != "float32":
            fp["train_precision"] = precision
        if net_type != "resnet50":
            fp["net_type"] = net_type
        for name, path in (("yolo_init", yolo_init),
                           ("yolo_draws", yolo_draws),
                           ("kpd_init", kpd_init), ("kpd_draws", kpd_draws)):
            if path:
                fp[name] = os.path.basename(path)
        check_params_dir(params_dir, fp)

    # ---- stage 2: render + annotate ----
    t0 = time.perf_counter()
    frames, poses, bboxes, parts = [], [], [], []
    for i in range(n_frames + n_eval):
        occ = occluder if occlusion and (i >= n_frames
                                         or rng.random() < 0.5) else None
        frame, pose, bbox = make_scene(rng, model, z_range, occluder=occ)
        _, kp_img = annotate_frame_exact(pose, model.vertices, kp3d, CAM_K)
        frames.append(frame)
        poses.append(pose)
        bboxes.append(bbox)
        parts.append(kp_img)
    frames = np.stack(frames)
    bboxes_np = np.asarray(bboxes, np.float32)
    parts_np = np.stack(parts).astype(np.float32)
    _mark(report, "render_s", t0)
    if verbose:
        print(f"rendered {len(frames)} scenes "
              f"({time.perf_counter() - t0:.1f}s)")

    # ---- stage 3a: train YOLO ----
    spec = yolo_mod.build_spec(YOLO_CFG.format(reso=reso))
    out_h, out_w = inp_h // 4, inp_w // 4
    if ypath and os.path.exists(ypath):
        yolo, _ = yolo_mod.load_darknet_weights(spec, ypath, reso,
                                                allow_partial=False)
        if verbose:
            print(f"yolo weights loaded from {ypath}")
    else:
        if yolo_init:
            yolo, _ = yolo_mod.load_darknet_weights(spec, yolo_init, reso,
                                                    allow_partial=False)
            yolo = yolo.to(dev)
        else:
            yolo = yolo_mod.Darknet(spec, reso,
                                    torch.Generator().manual_seed(0)).to(dev)
        replay = load_draws(yolo_draws, yolo_train.DRAWS, dev)
        ycfg = yolo_train.YoloTrainConfig(lr=1e-3, burn_in=200,
                                          steps=(10 ** 6,),
                                          scales=(0.1,), decay=5e-4)
        ystep = yolo_train.make_train_step(
            yolo, yolo_train.make_optimizer(yolo, ycfg), reso, reso,
            precision)
        truths = np.zeros((n_frames, 4, 5), np.float32)
        for i, bb in enumerate(bboxes[:n_frames]):
            truths[i, 0] = [(bb[0] + bb[2]) / 2 / 640,
                            (bb[1] + bb[3]) / 2 / 480,
                            (bb[2] - bb[0]) / 640, (bb[3] - bb[1]) / 480, 0]
        # uint8-resident frame pool, exact per-batch float convert
        full_u8 = torch.as_tensor(frames[:n_frames]).to(dev)
        truths_d = torch.as_tensor(truths).to(dev)
        B = 16
        sels = batch_indices(rng, n_frames, B, yolo_iters, dev)
        gen = torch.Generator(dev).manual_seed(3)
        t0 = time.perf_counter()
        for it in range(yolo_iters):
            sel = sels[it]
            imgs, tr = yolo_train.augment_detection_batch(
                full_u8[sel].float() / 255.0, truths_d[sel], ycfg, reso,
                reso, generator=gen, draws=None if replay is None else
                {k: v[it] for k, v in replay.items()})
            ym = ystep(imgs, tr)
            if step_hook is not None:
                step_hook("yolo", it)
        if yolo_iters:
            loss, iou = float(ym["loss"]), float(ym["head0/avg_iou"])
            _mark(report, "yolo_s", t0)
            if verbose:
                print(f"yolo trained {yolo_iters} iters (loss {loss:.3f}, "
                      f"iou {iou:.3f}, {time.perf_counter() - t0:.0f}s)")
        del full_u8, truths_d
        if ypath:
            yolo_mod.save_darknet_weights(yolo, ypath)

    # ---- stage 3b: train KPD ----
    arch = net_type
    if kpath and os.path.exists(kpath):
        kpd = ckpt.load_kpd_checkpoint(kpath, n_classes=n_kp, arch=arch)
        if verbose:
            print(f"kpd weights loaded from {kpath}")
    else:
        if kpd_init:
            kpd = ckpt.load_kpd_checkpoint(kpd_init, n_classes=n_kp,
                                           arch=arch).to(dev)
        else:
            gen_w = torch.Generator().manual_seed(1)
            kpd = (hgprm.PyraNet(n_kp, generator=gen_w) if arch == "hgPRM"
                   else kpd_mod.FastPose(n_kp, "resnet50", gen_w)).to(dev)
        kreplay = load_draws(kpd_draws, augment_draws, dev)
        # gentle augmentation for the toy task: the cube's mirror image
        # never occurs, and the tiny training budget can't absorb
        # flip/rotate noise
        aug_cfg = AugmentConfig(inp_h=inp_h, inp_w=inp_w, out_h=out_h,
                                out_w=out_w, rotate=0.0, train=True,
                                flip=False, add_dpg=add_dpg)
        imgs_u8 = torch.as_tensor(frames[:n_frames]).to(dev)
        bboxes_d = torch.as_tensor(bboxes_np[:n_frames]).to(dev)
        parts_d = torch.as_tensor(parts_np[:n_frames]).to(dev)
        gen = torch.Generator(dev).manual_seed(2)
        # kp_vis (occlusion-aware zero targets) is deliberately NOT used:
        # on the JAX package's occlusion tier it hurt (ADD<0.1d 0.25 vs
        # 0.62); a rigid object's hallucinated occluded keypoints are good
        # PnP correspondences
        batch = None
        for stage, lr, iters in (("kpd", 1e-3, kpd_iters),
                                 ("kpd_finetune", 1e-4, kpd_finetune_iters)):
            if not iters:
                continue
            # the low-LR phase: the subpixel localization that PnP depth
            # accuracy needs never falls out of a constant 1e-3 Adam
            kstep = kpd_train.make_train_step(
                kpd, kpd_train.make_optimizer(kpd.parameters(), "adam",
                                              lr=lr),
                out_res_h=out_h, precision=precision)
            sels = batch_indices(rng, n_frames, kpd_batch, iters, dev)
            t0 = time.perf_counter()
            for it in range(iters):
                sel = sels[it]
                batch = augment_batch(
                    imgs_u8[sel].float() / 255.0, bboxes_d[sel],
                    parts_d[sel], aug_cfg, generator=gen,
                    draws=None if kreplay is None or stage != "kpd" else
                    {k: v[it] for k, v in kreplay.items()})
                km = kstep(batch)
                if step_hook is not None:
                    step_hook(stage, it)
            loss, acc = float(km["loss"]), float(km["acc"])
            _mark(report, "kpd_s" if stage == "kpd" else "finetune_s", t0)
            if verbose:
                print(f"{stage} trained {iters} iters @{lr:g} "
                      f"(loss {loss:.5f}, acc {acc:.3f}, "
                      f"{time.perf_counter() - t0:.0f}s)")
        del imgs_u8
        if arch == "hgPRM" and batch is not None:
            # batch-stat training leaves running stats at init identity;
            # calibrate on the last augmented batch before inference use
            with torch.no_grad():
                kpd = hgprm.calibrate_bn(kpd, batch["inps"])
        if kpath:
            ckpt.save_kpd_npz(kpath, kpd)

    # ---- stage 3c: the pipeline on held-out frames ----
    pcfg = PipelineConfig(
        reso=reso, inp_h=inp_h, inp_w=inp_w, out_h=out_h, out_w=out_w,
        n_kp=n_kp, left_keypoints=left_keypoints or n_kp, confidence=0.005,
        compute_dtype="float32", pnp_robust_rounds=pnp_robust_rounds,
        pnp_score_power=pnp_score_power, det_capacity=det_capacity,
        net_type=net_type)
    pipe = PosePipeline(yolo_mod.fold_bn(yolo),
                        kpd if arch == "hgPRM" else kpd_mod.fold_bn(kpd),
                        kp3d, CAM_K, pcfg, device=dev)
    eval_frames = frames[n_frames:]
    t0 = time.perf_counter()
    out = to_numpy(pipe(eval_frames))
    _mark(report, "eval_s", t0)
    if eval_hook is not None:
        eval_hook(pipe, eval_frames)

    stats, adds = grade(out, poses[n_frames:], bboxes[n_frames:],
                        model.vertices)
    if verbose:
        where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "the CPU")
        print(f"eval of {n_eval} frames on {where} "
              f"({time.perf_counter() - t0:.1f}s)")
        print(f"eval: detected {stats['n_detected']}/{n_eval}, "
              f"ADD {stats['mean_add_m'] * 100:.2f} cm "
              f"(median {stats['median_add_m'] * 100:.2f}), "
              f"ADD<0.1d acc {stats['add_01d_acc']:.2f} "
              f"(0.1d = {0.1 * stats['diameter_m'] * 1000:.1f} mm), "
              f"2D {stats['mean_2d_px']:.1f} px "
              f"(median {stats['median_2d_px']:.1f}), "
              f"IoU {stats['mean_iou']:.3f}")
        print("per-frame ADD (mm):",
              np.round(np.sort(np.asarray(adds)) * 1000, 1).tolist())
    return stats


def grade(out, gt_poses, gt_bboxes, vertices):
    """The JAX selftest's stats of one eval: ADD, 2D reprojection error
    and IoU over the frames with a detection, and ADD<0.1d accuracy over
    all frames (the reference's success bar, `betapose_evaluate.py:249,
    263`; diameter = max vertex-pair distance).  Returns (stats, the
    per-frame ADD list)."""
    n_eval = len(gt_poses)
    diameter = float(np.sqrt(
        ((vertices[None] - vertices[:, None]) ** 2).sum(-1)).max())
    adds, errs2d, ious = [], [], []
    for j in range(n_eval):
        if not out["det_valid"][j]:
            continue
        pred = np.eye(4)
        pred[:3, :3] = out["cam_R"][j]
        pred[:3, 3] = out["cam_t"][j]
        adds.append(metrics.add_err(gt_poses[j], pred, vertices))
        errs2d.append(metrics.projection_error_2d(
            gt_poses[j], pred, vertices, CAM_K))
        ious.append(metrics.iou(gt_bboxes[j], out["boxes"][j].tolist()))
    ok_01d = [a < 0.1 * diameter for a in adds]
    return {
        "n_detected": len(adds),
        "n_eval": n_eval,
        "diameter_m": diameter,
        "mean_add_m": float(np.mean(adds)) if adds else float("inf"),
        "median_add_m": float(np.median(adds)) if adds else float("inf"),
        "add_01d_acc": float(np.sum(ok_01d)) / max(n_eval, 1),
        "mean_2d_px": float(np.mean(errs2d)) if errs2d else float("inf"),
        "median_2d_px": float(np.median(errs2d)) if errs2d else float("inf"),
        "mean_iou": float(np.mean(ious)) if ious else 0.0,
    }, adds


def make_parser():
    p = argparse.ArgumentParser(
        description="Betapose self-test on the card: render, train YOLO "
                    "and KPD, grade the pose pipeline")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--yolo_iters", type=int, default=250)
    p.add_argument("--kpd_iters", type=int, default=1500)
    p.add_argument("--eval_frames", type=int, default=None)
    p.add_argument("--params_dir", type=str, default=None,
                   help="cache trained weights here; reruns skip training")
    p.add_argument("--left_kp", type=int, default=None,
                   help="PnP keypoint pruning (default: all)")
    p.add_argument("--pnp_robust", type=int, default=None,
                   help="trimmed-IRLS robust-PnP rounds (default: 0 fast "
                        "tier, 2 slow tier)")
    p.add_argument("--slow", action="store_true",
                   help="accuracy tier: more scenes/iters and full "
                        "LineMod-sized KPD crops, targeting the reference's "
                        "ADD<0.1*diameter success metric")
    p.add_argument("--occlusion", action="store_true",
                   help="hard tier (implies --slow settings): every eval "
                        "frame has a foreground distractor hiding 15-50% "
                        "of the target; eval runs det_capacity=4 through "
                        "the multi-candidate pose-NMS path + robust PnP")
    p.add_argument("--det_capacity", type=int, default=None)
    p.add_argument("--train_precision", type=str, default=None,
                   choices=["bfloat16", "tensorfloat32", "float32"],
                   help="conv precision of both train steps (default: "
                        "kpd_train.DEFAULT_TRAIN_PRECISION, bfloat16)")
    p.add_argument("--netType", type=str, default="resnet50",
                   choices=["resnet50", "hgPRM"],
                   help="KPD backbone to train+grade (hgPRM: heatmap dims "
                        "inp/4 must divide by 16 — the slow-tier 320x256 "
                        "qualifies, the fast-tier 128x96 does not)")
    p.add_argument("--pnp_score_power", type=float, default=None,
                   help="PnP keypoint-score weighting exponent (default: "
                        "4 on the occlusion tier, 0 elsewhere)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda | cpu); cuda raises when no "
                        "CUDA device is present")
    return p


def tier_kwargs(args):
    """run_selftest's arguments for the parsed flags: the fast tier, or
    the --slow / --occlusion recipe of the JAX package."""
    if args.slow or args.occlusion:
        # occlusion trains at 2x scale (scenes + KPD iters): the
        # multi-candidate eval path only pays off once the heatmaps are
        # good enough under clutter
        return dict(
            n_frames=max(args.frames, 1600 if args.occlusion else 800),
            n_eval=args.eval_frames or 16,
            yolo_iters=max(args.yolo_iters, 1000 if args.occlusion else 500),
            kpd_iters=max(args.kpd_iters, 16000 if args.occlusion else 8000),
            kpd_finetune_iters=3000, kpd_batch=16,
            inp_h=320, inp_w=256, n_kp=26, add_dpg=True,
            z_range=(0.45, 0.65),
            # occlusion: keep ALL keypoints and let score**4 weighting do
            # the (soft) pruning inside PnP; clean tier: hard top-20
            left_keypoints=args.left_kp
            or (None if args.occlusion else 20),
            params_dir=args.params_dir,
            occlusion=args.occlusion,
            det_capacity=args.det_capacity
            or (4 if args.occlusion else 1),
            pnp_robust_rounds=2 if args.pnp_robust is None
            else args.pnp_robust,
            pnp_score_power=(4.0 if args.occlusion else 0.0)
            if args.pnp_score_power is None else args.pnp_score_power,
            train_precision=args.train_precision, net_type=args.netType)
    return dict(n_frames=args.frames, yolo_iters=args.yolo_iters,
                kpd_iters=args.kpd_iters, n_eval=args.eval_frames or 8,
                left_keypoints=args.left_kp, params_dir=args.params_dir,
                det_capacity=args.det_capacity or 1,
                pnp_robust_rounds=args.pnp_robust or 0,
                pnp_score_power=args.pnp_score_power or 0.0,
                train_precision=args.train_precision,
                net_type=args.netType)


def main(argv=None):
    args = make_parser().parse_args(argv)
    return run_selftest(device=args.device, **tier_kwargs(args))


if __name__ == "__main__":
    main()
