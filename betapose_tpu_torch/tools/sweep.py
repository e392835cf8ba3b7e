"""Multi-object accuracy sweep on the card: the reference's all-objects
evaluation loop on THIRTEEN distinct synthetic geometries.

Counterpart of `betapose_tpu/tools/sweep.py`.  The reference evaluates
LineMod one sequence per object with per-object YOLO/KPD weights and
prints a per-seq accuracy block (`betapose_evaluate.py:86-266`;
per-object weight table `KPD/src/main_fast_inference.py:29-36`; 15-class
detector cfg `cfg/yolo-linemod.cfg:689-696`).  This tier reproduces that
shape end to end on synthetic data:

1. thirteen objects (`tools/objects.py`: three symmetric — 2-fold prism,
   4-fold quad, flat slab — plus non-convex, thin, small, holed,
   textured, multi-part geometries), each with designated keypoints;
2. ONE shared multi-class detector at the production 416² shape —
   `make_yolov3_cfg(num_classes=15)` (13 of the 15 class slots are
   populated, as the reference trains its 15-class cfg on however many
   objects have data);
3. per-object KPD weights (FastPose-resnet50, 320x256 crops — the slow
   selftest recipe; symmetric objects train with the min-over-modes loss
   through `kpd_train.make_loss_fn(sym_perms=...)`);
4. per-object eval through `PosePipeline` with `target_class` routing
   (the peak-decode kernel on the card), graded ADD<0.1d — or ADD-S for
   symmetric objects — printed as the reference-style per-seq table.  For
   symmetric rows the table's 2D column is SYMMETRY-AWARE (min over
   modes); the plain number is kept in the JSON.

The detector trains from a device pool of the first `yolo_frames` frames
per object; each KPD pool is uploaded for its object and freed after.
`--out_json` is rewritten atomically after every row (a `.tmp` file, then
`os.replace`) with `"partial": true` until the last row, and the final
file carries `"partial": false`.  `main` refuses to start while another
process claims the card (`core/watchdog.chip_claimed`, exit code 4).

Run: python -m betapose_tpu_torch.tools.sweep --params_dir exp/sweep13 \\
       --yolo_iters 6000 --yolo_frames 300 --out_json sweep.json
(the first run trains 1 detector + 13 KPDs; reruns reload the per-object
weight caches and re-grade)
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
from betapose_tpu_torch.core.watchdog import (StallWatchdog, chip_claim_path,
                                              refuse_if_claimed)
from betapose_tpu_torch.eval.pipeline import (PipelineConfig, PosePipeline,
                                              to_numpy)
from betapose_tpu_torch.geometry import metrics
from betapose_tpu_torch.models import kpd as kpd_mod
from betapose_tpu_torch.models import yolov3 as yolo_mod
from betapose_tpu_torch.models.darknet_cfg import make_yolov3_cfg
from betapose_tpu_torch.tools import objects as objects_mod
from betapose_tpu_torch.tools.annotator import annotate_frame_exact
from betapose_tpu_torch.tools.selftest import (CACHE_VERSION, CAM_K,
                                               batch_indices,
                                               check_params_dir, make_scene,
                                               resolved_precision)
from betapose_tpu_torch.train import kpd_train, yolo_train
from betapose_tpu_torch.train.augment import AugmentConfig, augment_batch

# progress lines read the loss every this many steps (a host sync)
LOG_EVERY = 500


def render_sequence(rng, obj, n, z_range, canonical=True):
    """Render n single-object scenes; annotate keypoints through the
    SYMMETRY-CANONICALIZED pose (objects.canonicalize_pose) so identical-
    looking views get identical labels.  Returns (frames u8 [N,480,640,3],
    raw GT poses [N,4,4], bboxes [N,4] xyxy, kp_img [N,K,2])."""
    frames, poses, bboxes, parts = [], [], [], []
    for _ in range(n):
        frame, pose, bbox = make_scene(rng, obj, z_range)
        ann_pose = (objects_mod.canonicalize_pose(pose, obj.symmetries)
                    if canonical else pose)
        # exact-identity annotation (annotate_frame_exact docstring): the
        # mask-bbox ratio trick costs ~1% constellation scale == ~1cm ADD
        _, kp_img = annotate_frame_exact(ann_pose, obj.vertices,
                                         obj.keypoints, CAM_K)
        frames.append(frame)
        poses.append(pose)
        bboxes.append(bbox)
        parts.append(kp_img)
    return (np.stack(frames), np.stack(poses),
            np.asarray(bboxes, np.float32), np.stack(parts).astype(np.float32))


def train_detector(spec, frames_u8_dev, truths, iters, batch, reso,
                   precision, seed=0, verbose=True, beat=None):
    """Shared multi-class detector at the production shape (darknet
    random-init training, burn-in LR, crop-jitter/flip/HSV augmentation
    on the device — `detector.c:38-226` semantics).  frames_u8_dev: the
    uint8 pool on the device it trains on.  Returns the `Darknet`."""
    dev = frames_u8_dev.device
    ycfg = yolo_train.YoloTrainConfig(lr=1e-3, burn_in=min(400, iters // 4),
                                      steps=(int(iters * 0.8),),
                                      scales=(0.1,), decay=5e-4)
    model = yolo_mod.Darknet(spec, reso,
                             torch.Generator().manual_seed(seed)).to(dev)
    step = yolo_train.make_train_step(
        model, yolo_train.make_optimizer(model, ycfg), reso, reso,
        resolved_precision(precision))
    truths_d = torch.as_tensor(truths).to(dev)
    sels = batch_indices(np.random.default_rng(seed + 1),
                         frames_u8_dev.shape[0], batch, iters, dev)
    gen = torch.Generator(dev).manual_seed(seed + 2)
    t0 = time.perf_counter()
    for it in range(iters):
        sel = sels[it]
        aug_i, aug_t = yolo_train.augment_detection_batch(
            frames_u8_dev[sel].float() / 255.0, truths_d[sel], ycfg, reso,
            reso, generator=gen)
        m = step(aug_i, aug_t)
        if beat is not None:
            beat()
        if verbose and (it + 1) % LOG_EVERY == 0:
            print(f"  yolo iter {it + 1}/{iters} "
                  f"loss {float(m['loss']):.3f} "
                  f"iou {float(m['head0/avg_iou']):.3f} "
                  f"({time.perf_counter() - t0:.0f}s)")
    if verbose and iters:
        print(f"  yolo trained {iters} iters (loss {float(m['loss']):.3f}, "
              f"{time.perf_counter() - t0:.0f}s)")
    return model


def train_kpd(frames_u8_dev, bboxes, parts, n_kp, iters, finetune_iters,
              batch, inp_h, inp_w, precision, seed=1, verbose=True,
              sym_perms=None, beat=None):
    """Per-object KPD (FastPose-resnet50) — the slow selftest recipe:
    Adam 1e-3 then a 1e-4 subpixel-convergence phase, DPG augmentation on
    the device, masked-MSE heatmap loss.  For symmetric objects, sym_perms
    switches the loss to the min-over-modes form (`kpd_train.make_loss_fn`):
    a fixed canonicalization alone leaves a label seam in SO(3) that plain
    MSE blurs across.  Returns the `FastPose` (BN not folded)."""
    dev = frames_u8_dev.device
    out_h, out_w = inp_h // 4, inp_w // 4
    model = kpd_mod.FastPose(n_kp, "resnet50",
                             torch.Generator().manual_seed(seed)).to(dev)
    aug_cfg = AugmentConfig(inp_h=inp_h, inp_w=inp_w, out_h=out_h,
                            out_w=out_w, rotate=0.0, train=True,
                            flip=False, add_dpg=True)
    bboxes_d = torch.as_tensor(bboxes).to(dev)
    parts_d = torch.as_tensor(parts).to(dev)
    n = frames_u8_dev.shape[0]
    rng = np.random.default_rng(seed + 10)
    gen = torch.Generator(dev).manual_seed(seed + 11)
    for phase, (lr, n_iters) in enumerate(
            [(1e-3, iters), (1e-4, finetune_iters)]):
        if n_iters <= 0:
            continue
        step = kpd_train.make_train_step(
            model, kpd_train.make_optimizer(model.parameters(), "adam",
                                            lr=lr),
            out_res_h=out_h, precision=resolved_precision(precision),
            sym_perms=sym_perms)
        sels = batch_indices(rng, n, batch, n_iters, dev)
        t0 = time.perf_counter()
        for it in range(n_iters):
            sel = sels[it]
            b = augment_batch(frames_u8_dev[sel].float() / 255.0,
                              bboxes_d[sel], parts_d[sel], aug_cfg,
                              generator=gen)
            m = step(b)
            if beat is not None:
                beat()
        if verbose:
            print(f"  kpd phase {phase} ({n_iters} iters @{lr:g}): "
                  f"loss {float(m['loss']):.5f} acc {float(m['acc']):.3f} "
                  f"({time.perf_counter() - t0:.0f}s)")
    return model


def evaluate_object(pipe, eval_frames, eval_poses, eval_bboxes, obj,
                    pixel_thresh=5.0):
    """Pipeline eval of one object's held-out frames; grades BOTH plain
    ADD and ADD-S so the symmetric object's table row shows the metric
    divergence explicitly (`betapose_evaluate.py:249-266` loop semantics:
    IoU>=0.5 gate, ADD < diameter/10)."""
    out = to_numpy(pipe(eval_frames))
    n_eval = len(eval_frames)
    add_ok, adds_ok, add_errs, adds_errs, proj, proj_sym, ious, detected = \
        [], [], [], [], [], [], [], 0
    # symmetry modes as 4x4 right-multipliers of the GT pose: projecting
    # the (self-mapping) vertex set under R·S is the symmetric twin of
    # the GT view, so min-over-modes reprojection grades a legitimately-
    # flipped prediction fairly (plain 2D reproj treats it as tens of px)
    sym_poses = [np.eye(4)]
    for S in obj.symmetries:
        M = np.eye(4)
        M[:3, :3] = np.asarray(S)
        sym_poses.append(M)
    for j in range(n_eval):
        if not out["det_valid"][j]:
            continue
        detected += 1
        gt_pose = eval_poses[j]
        pred = np.eye(4)
        pred[:3, :3] = out["cam_R"][j]
        pred[:3, 3] = out["cam_t"][j]
        gb = eval_bboxes[j]
        iou = metrics.iou(gb.tolist(), out["boxes"][j].tolist())
        ious.append(iou)
        if iou < 0.5:
            continue
        a = metrics.add_err(gt_pose, pred, obj.vertices)
        s = metrics.adds_err(gt_pose, pred, obj.vertices)
        add_errs.append(a)
        adds_errs.append(s)
        add_ok.append(a < 0.1 * obj.diameter)
        adds_ok.append(s < 0.1 * obj.diameter)
        proj.append(metrics.projection_error_2d(
            gt_pose, pred, obj.vertices, CAM_K))
        proj_sym.append(min(
            metrics.projection_error_2d(gt_pose @ M, pred, obj.vertices,
                                        CAM_K) for M in sym_poses))
    return {
        "object": obj.name,
        "symmetric": bool(obj.symmetries),
        "n_eval": n_eval,
        "n_detected": detected,
        "diameter_m": obj.diameter,
        "add_acc": float(np.sum(add_ok)) / max(n_eval, 1),
        "adds_acc": float(np.sum(adds_ok)) / max(n_eval, 1),
        "mean_add_m": float(np.mean(add_errs)) if add_errs else float("inf"),
        "mean_adds_m": (float(np.mean(adds_errs)) if adds_errs
                        else float("inf")),
        "mean_2d_px": float(np.mean(proj)) if proj else float("inf"),
        "mean_2d_px_sym": (float(np.mean(proj_sym)) if proj_sym
                           else float("inf")),
        "mean_iou": float(np.mean(ious)) if ious else 0.0,
    }


def run_sweep(object_names=None, n_frames=800,
              n_eval=16, yolo_iters=3000, kpd_iters=8000,
              kpd_finetune_iters=3000, kpd_batch=16, yolo_batch=8,
              reso=416, inp_h=320, inp_w=256, n_kp=26, num_classes=15,
              seed=0, z_range=(0.45, 0.65), params_dir=None,
              train_precision=None, left_keypoints=20, verbose=True,
              yolo_frames=None, pnp_score_power=0.0, pnp_spread_power=0.0,
              pnp_depth_prior=0.0, det_capacity=1, beat=None,
              out_json=None, device=None, report=None, eval_hook=None):
    """Returns {"per_object": [row...], "all_pass_085": bool}.

    out_json: if set, the per-object table is rewritten atomically to this
    file after EVERY completed row, with "partial": true until the last
    row, and once more at the end with the summary — an interrupted run
    leaves its completed rows on disk, and the rerun that resumes from the
    --params_dir caches overwrites the file with the full table.

    beat: optional zero-arg liveness callback (core.watchdog) invoked
    after every training step / render / eval.

    yolo_frames: detector training uses the first yolo_frames frames of
    each object (default: all n_frames), which caps the detector's device
    pool, while KPD trains on the full per-object set (uploaded one
    object at a time).

    device: None means CUDA (raises without it).  report: a dict to fill
    with "render_s", "yolo_s" (None when loaded), and per-object "kpd_s"
    and "eval_s" lists.  eval_hook(pipe, eval_frames): called after each
    object's eval with its pipeline and frames."""
    dev = resolve_device(device)
    if object_names is None:
        object_names = tuple(objects_mod.OBJECT_BUILDERS)
    objs = [objects_mod.OBJECT_BUILDERS[n](n_kp) for n in object_names]
    yolo_n = min(yolo_frames or n_frames, n_frames)
    report = {} if report is None else report

    ypath = kpaths = None
    if params_dir:
        fp = {"cache_version": CACHE_VERSION, "objects": list(object_names),
              "n_frames": n_frames, "reso": reso, "inp_h": inp_h,
              "inp_w": inp_w, "n_kp": n_kp, "num_classes": num_classes,
              "seed": seed, "z_range": list(z_range),
              "yolo_iters": yolo_iters, "kpd_iters": kpd_iters,
              "kpd_finetune_iters": kpd_finetune_iters,
              "kpd_batch": kpd_batch, "yolo_batch": yolo_batch,
              # symmetric objects train with the min-over-modes loss;
              # caches trained under plain canonicalized MSE must refuse
              "sym_loss": True,
              # per-sequence render streams (rng keyed by [seed, ci])
              "render_rng": "per-seq"}
        if yolo_n != n_frames:
            fp["yolo_frames"] = yolo_n
        precision = resolved_precision(train_precision)
        if precision != "float32":
            fp["train_precision"] = precision
        check_params_dir(params_dir, fp, epoch_key=None,
                         what="sweep params_dir")
        ypath = os.path.join(params_dir, "yolo.weights")
        kpaths = {o.name: os.path.join(params_dir, f"kpd_{o.name}.npz")
                  for o in objs}

    # ---- render + annotate every sequence ----
    # rng keyed per sequence so a crashed/resumed run re-renders the
    # identical streams regardless of which objects are cached
    seqs = []
    t_render = time.perf_counter()
    for ci, obj in enumerate(objs):
        t0 = time.perf_counter()
        rng = np.random.default_rng([seed, 101 + ci])
        fr, po, bb, pa = render_sequence(rng, obj, n_frames + n_eval,
                                         z_range)
        seqs.append({"obj": obj, "class_id": ci,
                     "frames": fr[:n_frames], "bboxes": bb[:n_frames],
                     "parts": pa[:n_frames],
                     "eval_frames": fr[n_frames:],
                     "eval_poses": po[n_frames:],
                     "eval_bboxes": bb[n_frames:]})
        if verbose:
            print(f"rendered seq {ci + 1:02d} ({obj.name}): "
                  f"{n_frames}+{n_eval} scenes "
                  f"({time.perf_counter() - t0:.0f}s)")
        if beat is not None:
            beat()
    report["render_s"] = time.perf_counter() - t_render

    # ---- shared production-shape detector ----
    spec = yolo_mod.build_spec(make_yolov3_cfg(
        num_classes=num_classes, width=reso, height=reso))
    report["yolo_s"] = None
    if not (ypath and os.path.exists(ypath)):
        # device-resident uint8 detector pool: the first yolo_n frames of
        # every object; freed before the KPD phase
        all_dev = torch.cat([torch.as_tensor(s["frames"][:yolo_n]).to(dev)
                             for s in seqs])
        truths = np.zeros((len(seqs) * yolo_n, 4, 5), np.float32)
        for si, s in enumerate(seqs):
            for i, bb in enumerate(s["bboxes"][:yolo_n]):
                truths[si * yolo_n + i, 0] = [
                    (bb[0] + bb[2]) / 2 / 640, (bb[1] + bb[3]) / 2 / 480,
                    (bb[2] - bb[0]) / 640, (bb[3] - bb[1]) / 480,
                    s["class_id"]]
        if verbose:
            print(f"training shared detector: {num_classes}-class yolov3 "
                  f"@{reso}² on {len(truths)} frames")
        t0 = time.perf_counter()
        yolo = train_detector(spec, all_dev, truths, yolo_iters, yolo_batch,
                              reso, train_precision, seed=seed,
                              verbose=verbose, beat=beat)
        report["yolo_s"] = time.perf_counter() - t0
        del all_dev
        if ypath:
            yolo_mod.save_darknet_weights(yolo, ypath)
    else:
        yolo, _ = yolo_mod.load_darknet_weights(spec, ypath, reso,
                                                allow_partial=False)
        if verbose:
            print(f"yolo weights loaded from {ypath}")
    yfolded = yolo_mod.fold_bn(yolo)

    # ---- per-object KPD + eval ----
    rows = []
    report["kpd_s"], report["eval_s"] = [], []
    for s in seqs:
        obj = s["obj"]
        kpath = kpaths[obj.name] if kpaths else None
        t0 = time.perf_counter()
        if kpath and os.path.exists(kpath):
            kpd = ckpt.load_kpd_checkpoint(kpath, n_classes=n_kp,
                                           arch="resnet50")
            if verbose:
                print(f"kpd[{obj.name}] loaded from {kpath}")
        else:
            if verbose:
                print(f"training kpd[{obj.name}]")
            pool_dev = torch.as_tensor(s["frames"]).to(dev)
            kpd = train_kpd(pool_dev, s["bboxes"], s["parts"], n_kp,
                            kpd_iters, kpd_finetune_iters, kpd_batch, inp_h,
                            inp_w, train_precision,
                            seed=seed + s["class_id"], verbose=verbose,
                            sym_perms=obj.symmetry_perms or None, beat=beat)
            del pool_dev
            if kpath:
                ckpt.save_kpd_npz(kpath, kpd)
        report["kpd_s"].append(time.perf_counter() - t0)
        pcfg = PipelineConfig(
            reso=reso, inp_h=inp_h, inp_w=inp_w,
            out_h=inp_h // 4, out_w=inp_w // 4, n_kp=n_kp,
            left_keypoints=left_keypoints, confidence=0.005,
            compute_dtype="float32", pnp_robust_rounds=2,
            target_class=s["class_id"], pnp_score_power=pnp_score_power,
            pnp_spread_power=pnp_spread_power,
            pnp_depth_prior=pnp_depth_prior, det_capacity=det_capacity,
            net_type="resnet50")
        pipe = PosePipeline(yfolded, kpd_mod.fold_bn(kpd), obj.keypoints,
                            CAM_K, pcfg, device=dev)
        t0 = time.perf_counter()
        row = evaluate_object(pipe, s["eval_frames"], s["eval_poses"],
                              s["eval_bboxes"], obj)
        report["eval_s"].append(time.perf_counter() - t0)
        if eval_hook is not None:
            eval_hook(pipe, s["eval_frames"])
        row["seq"] = s["class_id"] + 1
        rows.append(row)
        if out_json:
            write_json_atomic(out_json, {"per_object": rows, "partial":
                                         len(rows) < len(seqs)})
        if beat is not None:
            beat()
        if verbose:
            acc = row["adds_acc"] if row["symmetric"] else row["add_acc"]
            print(f"Mean add{'(-S)' if row['symmetric'] else ''} accuracy "
                  f"for seq {row['seq']:02d} is: {acc:.3f}")

    # ---- per-seq table (the reference's per-object readout as a block) --
    # symmetric rows show the symmetry-aware (min over modes) 2D reproj,
    # marked "*": the plain number grades a legitimately-flipped mode
    # with an asymmetric metric (mean_2d_px keeps it in the JSON)
    if verbose:
        print("\nseq  object   metric  acc    add_acc  adds_acc  "
              "err_cm   2d_px   iou    det")
        for r in rows:
            metric = "ADD-S" if r["symmetric"] else "ADD"
            acc = r["adds_acc"] if r["symmetric"] else r["add_acc"]
            err = r["mean_adds_m"] if r["symmetric"] else r["mean_add_m"]
            px = (r["mean_2d_px_sym"] if r["symmetric"]
                  else r["mean_2d_px"])
            px_s = f"{px:.1f}{'*' if r['symmetric'] else ' '}"
            print(f"{r['seq']:02d}   {r['object']:<8} {metric:<7} "
                  f"{acc:<6.2f} {r['add_acc']:<8.2f} {r['adds_acc']:<9.2f} "
                  f"{err * 100:<8.2f} {px_s:<7} "
                  f"{r['mean_iou']:<6.3f} "
                  f"{r['n_detected']}/{r['n_eval']}")
    graded = [r["adds_acc"] if r["symmetric"] else r["add_acc"]
              for r in rows]
    out = {"per_object": rows,
           "all_pass_085": bool(all(a >= 0.85 for a in graded))}
    if out_json:
        write_json_atomic(out_json, dict(out, partial=False))
    return out


def json_sanitize(x):
    """Replace non-finite floats with None so --out_json emits strict
    JSON (json.dump would write the non-standard `Infinity` token for
    the no-detection sentinel float('inf'))."""
    if isinstance(x, dict):
        return {k: json_sanitize(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [json_sanitize(v) for v in x]
    if isinstance(x, float) and not np.isfinite(x):
        return None
    return x


def write_json_atomic(path, obj):
    """json_sanitize(obj) to `path` through `path.tmp` and `os.replace`:
    a process killed mid-write (the watchdog's `os._exit`) leaves the
    previous file whole, never a truncated one."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(json_sanitize(obj), f, indent=1)
    os.replace(tmp, path)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--objects", type=str, default="all",
                   help="comma list of objects.OBJECT_BUILDERS names, or "
                        "'all' for the full 13-object roster")
    p.add_argument("--frames", type=int, default=800)
    p.add_argument("--eval_frames", type=int, default=16)
    p.add_argument("--yolo_iters", type=int, default=3000)
    p.add_argument("--yolo_frames", type=int, default=None,
                   help="detector pool size per object (default: all "
                        "--frames; cap it for the 13-object run — see "
                        "run_sweep)")
    p.add_argument("--kpd_iters", type=int, default=8000)
    p.add_argument("--kpd_finetune", type=int, default=3000)
    p.add_argument("--num_classes", type=int, default=15,
                   help="detector head width (production yolo-linemod.cfg "
                        "= 15; only len(--objects) slots get data)")
    p.add_argument("--reso", type=int, default=416)
    p.add_argument("--params_dir", type=str, default=None)
    p.add_argument("--train_precision", type=str, default=None,
                   choices=["bfloat16", "tensorfloat32", "float32"])
    p.add_argument("--out_json", type=str, default=None,
                   help="write the per-object result table to this file")
    p.add_argument("--left_keypoints", type=int, default=20)
    p.add_argument("--det_capacity", type=int, default=1)
    p.add_argument("--pnp_score_power", type=float, default=0.0)
    p.add_argument("--pnp_spread_power", type=float, default=0.0)
    p.add_argument("--pnp_depth_prior", type=float, default=0.0)
    p.add_argument("--stall_timeout", type=float, default=900.0,
                   help="hard-exit (code 3) if no step/render/eval "
                        "completes for this many seconds; rerun to resume "
                        "from --params_dir caches.  0 disables")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda | cpu)")
    args = p.parse_args(argv)
    names = (tuple(objects_mod.OBJECT_BUILDERS) if args.objects == "all"
             else tuple(args.objects.split(",")))
    refuse_if_claimed("sweep")
    with StallWatchdog(args.stall_timeout, label="sweep",
                       yield_to=chip_claim_path()) as wd:
        return run_sweep(object_names=names,
                         n_frames=args.frames, n_eval=args.eval_frames,
                         yolo_iters=args.yolo_iters,
                         kpd_iters=args.kpd_iters,
                         kpd_finetune_iters=args.kpd_finetune,
                         num_classes=args.num_classes, reso=args.reso,
                         params_dir=args.params_dir,
                         train_precision=args.train_precision,
                         yolo_frames=args.yolo_frames,
                         left_keypoints=args.left_keypoints,
                         det_capacity=args.det_capacity,
                         pnp_score_power=args.pnp_score_power,
                         pnp_spread_power=args.pnp_spread_power,
                         pnp_depth_prior=args.pnp_depth_prior,
                         beat=wd.beat if wd.enabled else None,
                         out_json=args.out_json, device=args.device)


if __name__ == "__main__":
    main()
