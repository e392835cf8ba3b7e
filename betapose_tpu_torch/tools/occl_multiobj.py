"""Multi-object occlusion tier on the card: two graded targets + a
distractor in the SAME frames, evaluated per object through the port's
occlusion CLI.

Counterpart of `betapose_tpu/tools/occl_multiobj.py`.  The reference
occlusion benchmark's defining shape (`occlusion_betapose_evaluate.py:
204-218`): ONE scene (seq 02) whose frames carry every object's GT; the
CLI runs once per object with that object's single-class YOLO + KPD
weights, and its metric loop iterates all GT entries keeping its
object's.  This tier composes scenes of

    cube (obj 1) + L-wedge (obj 2) + drab distractor

with real mutual and distractor occlusion, trains per-object
single-class detectors (yolo-linemod-single shape) and per-object KPD on
the cluttered frames (`tools/sweep.train_detector` / `train_kpd`), writes
the held-out frames as a SIXD tree (rgb pngs / gt.yml with both objects
per frame / models ply / kpmodels ply / models_info.yml), and then runs
`eval/occlusion_betapose_evaluate.main` per object against that tree,
multi-candidate device pose-NMS and score-weighted robust PnP included.

`--out_json` is written atomically (a `.tmp` file, then `os.replace`)
with `"partial": false`; `main` refuses to start while another process
claims the card (exit code 4).

Run: python -m betapose_tpu_torch.tools.occl_multiobj --params_dir exp/occl_mo
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

import numpy as np
import torch
import yaml

from betapose_tpu_torch.core import checkpoint as ckpt
from betapose_tpu_torch.core.device import resolve_device
from betapose_tpu_torch.core.watchdog import (StallWatchdog, chip_claim_path,
                                              refuse_if_claimed)
from betapose_tpu_torch.data import ply as plyio
from betapose_tpu_torch.geometry.renderer import Renderer
from betapose_tpu_torch.geometry.utils import get_bbox_from_mask
from betapose_tpu_torch.models import yolov3 as yolo_mod
from betapose_tpu_torch.models.darknet_cfg import make_yolov3_cfg
from betapose_tpu_torch.tools import objects as objects_mod
from betapose_tpu_torch.tools.annotator import annotate_frame_exact
from betapose_tpu_torch.tools.selftest import (CACHE_VERSION, CAM_K,
                                               check_params_dir,
                                               distractor_model,
                                               resolved_precision)
from betapose_tpu_torch.tools.sweep import (train_detector, train_kpd,
                                            write_json_atomic)

OCCLUSION_SEQ = 2  # the reference's occlusion GT scene id


def _euler(rng, tilt=0.8):
    ang = np.array([rng.uniform(-tilt, tilt), rng.uniform(-tilt, tilt),
                    rng.uniform(0, 2 * np.pi)])

    def rot(a, axis):
        c, s = np.cos(a), np.sin(a)
        m = np.eye(3)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
        return m

    return rot(ang[0], 0) @ rot(ang[1], 1) @ rot(ang[2], 2)


def make_multi_scene(rng, models, distractor, z_range=(0.5, 0.7),
                     occl_frac=(0.15, 0.5)):
    """Compose len(models) targets + a foreground distractor by global
    z-buffer.  models: list of MeshObject.  The distractor is retried
    until it hides occl_frac of one (randomly chosen) target's pixels;
    the OTHER target still sees target-target occlusion whenever the
    lateral draws overlap.  Returns (frame u8, per-target list of
    (pose 4x4, bbox xyxy of the FULL object, occluded_fraction))."""
    n = len(models)
    # lateral slots keep both targets in frame; jitter inside each slot
    slots = rng.permutation(n)
    renders = []
    poses = []
    for mi, m in enumerate(models):
        pose = np.eye(4)
        pose[:3, :3] = _euler(rng)
        x0 = (-0.075 + 0.15 * (slots[mi] / max(n - 1, 1))
              + rng.uniform(-0.02, 0.02))
        pose[:3, 3] = [x0, rng.uniform(-0.05, 0.05),
                       rng.uniform(*z_range)]
        r = Renderer(size=(640, 480), cam=CAM_K)
        r.draw_model(m, pose)
        rgb, depth = r.finish()
        renders.append((rgb, np.where(depth > 0, depth, np.inf)))
        poses.append(pose)

    # distractor in front of a randomly chosen victim
    victim = int(rng.integers(0, n))
    vic_t = poses[victim][:3, 3]
    vic_mask = np.isfinite(renders[victim][1])
    vic_area = max(int(vic_mask.sum()), 1)
    d_render = None
    for _ in range(12):
        o_pose = np.eye(4)
        o_pose[:3, :3] = _euler(rng, tilt=np.pi)
        side = rng.uniform(0, 2 * np.pi)
        off = rng.uniform(0.25, 0.9) * 0.04
        o_pose[:3, 3] = vic_t + [np.cos(side) * (0.04 + off) * 0.9,
                                 np.sin(side) * (0.04 + off) * 0.9,
                                 -rng.uniform(0.06, 0.12)]
        ro = Renderer(size=(640, 480), cam=CAM_K)
        ro.draw_model(distractor, o_pose)
        rgb_o, depth_o = ro.finish()
        dd = np.where(depth_o > 0, depth_o, np.inf)
        frac = float((np.isfinite(dd) & vic_mask
                      & (dd < renders[victim][1])).sum()) / vic_area
        if occl_frac[0] <= frac <= occl_frac[1]:
            d_render = (rgb_o, dd)
            break
    if d_render is not None:
        renders.append(d_render)

    depths = np.stack([d for _, d in renders])      # [n(+1), H, W]
    owner = np.argmin(depths, axis=0)
    any_hit = np.isfinite(depths.min(axis=0))
    frame = (rng.random((480, 640, 3)) * 0.25 * 255).astype(np.uint8)
    for bi, (rgb, d) in enumerate(renders):
        sel = any_hit & (owner == bi) & np.isfinite(d)
        frame[sel] = np.clip(rgb[sel] * 255, 0, 255).astype(np.uint8)

    out = []
    for mi in range(n):
        mask = np.isfinite(renders[mi][1])
        xmin, xmax, ymin, ymax = get_bbox_from_mask(mask)
        visible = mask & (owner == mi)
        occ = 1.0 - float(visible.sum()) / max(int(mask.sum()), 1)
        out.append((poses[mi], [xmin, ymin, xmax, ymax], occ))
    return frame, out


def write_sixd_tree(base, objs, eval_frames, eval_gt):
    """Materialize the eval scenes as a SIXD/Occlusion-LineMod tree the
    CLI loads: models + kpmodels ply (mm), models_info.yml (diameter mm),
    seq-02 rgb pngs, gt.yml with EVERY object's entry per frame."""
    import cv2
    os.makedirs(os.path.join(base, "models"), exist_ok=True)
    os.makedirs(os.path.join(base, "kpmodels"), exist_ok=True)
    seq = os.path.join(base, "test", "%02d" % OCCLUSION_SEQ)
    os.makedirs(os.path.join(seq, "rgb"), exist_ok=True)

    info = {}
    for obj_id, o in objs.items():
        plyio.write_vertices_ascii(
            os.path.join(base, "models", f"obj_{obj_id:02d}.ply"),
            o.vertices * 1000.0)
        plyio.write_vertices_ascii(
            os.path.join(base, "kpmodels", f"obj_{obj_id:02d}.ply"),
            o.keypoints * 1000.0)
        info[obj_id] = {"diameter": float(o.diameter * 1000.0)}
    with open(os.path.join(base, "models", "models_info.yml"), "w") as f:
        yaml.safe_dump(info, f)

    gts, infos = {}, {}
    cam = [float(v) for v in CAM_K.reshape(-1)]
    for i, (frame, per_obj) in enumerate(zip(eval_frames, eval_gt)):
        cv2.imwrite(os.path.join(seq, "rgb", f"{i:04d}.png"),
                    frame[:, :, ::-1])                  # RGB -> BGR on disk
        entries = []
        for obj_id, (pose, bbox, _occ) in per_obj.items():
            entries.append({
                "cam_R_m2c": [float(v) for v in pose[:3, :3].reshape(-1)],
                "cam_t_m2c": [[float(v * 1000.0)] for v in pose[:3, 3]],
                "obj_bb": [int(bbox[0]), int(bbox[1]),
                           int(bbox[2] - bbox[0]), int(bbox[3] - bbox[1])],
                "obj_id": int(obj_id),
            })
        gts[i] = entries
        infos[i] = {"cam_K": cam}
    with open(os.path.join(seq, "gt.yml"), "w") as f:
        yaml.safe_dump(gts, f)
    with open(os.path.join(seq, "info.yml"), "w") as f:
        yaml.safe_dump(infos, f)
    return os.path.join(seq, "rgb")


def run_occl_multiobj(n_frames=800, n_eval=32, yolo_iters=2000,
                      kpd_iters=8000, kpd_finetune_iters=3000,
                      kpd_batch=16, yolo_batch=8, reso=416, inp_h=320,
                      inp_w=256, n_kp=26, seed=0, params_dir=None,
                      work_dir=None, train_precision=None, verbose=True,
                      pnp_grid=None, beat=None, device=None,
                      eval_hook=None):
    """Returns per-object stats dicts from the occlusion CLI (or, with
    pnp_grid, one such dict per combo, keyed by its tag).

    beat: optional liveness callback (core.watchdog) — see
    sweep.run_sweep.  device: None means CUDA (raises without it).
    eval_hook(pipe, eval_frames): called after each run of the occlusion
    CLI with its pipeline and the held-out frames it read from the tree.
    Without params_dir / work_dir the weights / the tree live in
    temporary directories that are removed on return."""
    dev = resolve_device(device)
    objs = {1: objects_mod.cube_object(n_kp),
            2: objects_mod.lwedge_object(n_kp)}
    distractor = distractor_model()

    if params_dir:
        fp = {"cache_version": CACHE_VERSION, "tier": "occl_multiobj",
              "objects": sorted(objs), "n_frames": n_frames, "reso": reso,
              "inp_h": inp_h, "inp_w": inp_w, "n_kp": n_kp, "seed": seed,
              "yolo_iters": yolo_iters, "kpd_iters": kpd_iters,
              "kpd_finetune_iters": kpd_finetune_iters,
              "kpd_batch": kpd_batch, "yolo_batch": yolo_batch}
        precision = resolved_precision(train_precision)
        if precision != "float32":
            fp["train_precision"] = precision
        check_params_dir(params_dir, fp, epoch_key=None,
                         what="occl_multiobj params_dir")

    # weights and the SIXD tree that the caller did not place go to
    # temporary directories, removed on return
    with contextlib.ExitStack() as stack:
        def temp_dir(prefix):
            return stack.enter_context(
                tempfile.TemporaryDirectory(prefix=prefix))

        # ---- compose the cluttered scene set ----
        rng = np.random.default_rng(seed)
        t0 = time.perf_counter()
        frames, gt = [], []
        occ_sums = {k: [] for k in objs}
        for _ in range(n_frames + n_eval):
            frame, per = make_multi_scene(rng, list(objs.values()), distractor)
            frames.append(frame)
            entry = {}
            for oid, (pose, bbox, occ) in zip(objs, per):
                entry[oid] = (pose, bbox, occ)
                occ_sums[oid].append(occ)
            gt.append(entry)
        frames = np.stack(frames)
        if verbose:
            occ_str = ", ".join(
                f"obj{k}: {np.mean(v):.2f}" for k, v in occ_sums.items())
            print(f"rendered {len(frames)} multi-object scenes "
                  f"(mean occluded fraction {occ_str}; "
                  f"{time.perf_counter() - t0:.0f}s)")

        train_u8 = torch.as_tensor(frames[:n_frames]).to(dev)
        spec = yolo_mod.build_spec(make_yolov3_cfg(num_classes=1, width=reso,
                                                   height=reso))

        # ---- per-object weights (reference: single-class detector + KPD
        # per object, main_fast_inference.py:29-36 weight table) ----
        weight_dir = params_dir or temp_dir("occl_mo_weights_")
        weight_paths = {}
        for oid, o in objs.items():
            ypath = os.path.join(weight_dir, f"yolo_{oid:02d}.weights")
            kpath = os.path.join(weight_dir, f"kpd_{oid:02d}.npz")
            if not (params_dir and os.path.exists(ypath)):
                truths = np.zeros((n_frames, 4, 5), np.float32)
                for i in range(n_frames):
                    bb = gt[i][oid][1]
                    truths[i, 0] = [(bb[0] + bb[2]) / 2 / 640,
                                    (bb[1] + bb[3]) / 2 / 480,
                                    (bb[2] - bb[0]) / 640,
                                    (bb[3] - bb[1]) / 480, 0]
                if verbose:
                    print(f"training detector[obj {oid}] (single-class "
                          f"@{reso}²)")
                yolo = train_detector(spec, train_u8, truths, yolo_iters,
                                      yolo_batch, reso, train_precision,
                                      seed=seed + oid, verbose=verbose,
                                      beat=beat)
                yolo_mod.save_darknet_weights(yolo, ypath)
            if not (params_dir and os.path.exists(kpath)):
                bboxes = np.asarray([gt[i][oid][1] for i in range(n_frames)],
                                    np.float32)
                parts = np.stack([
                    annotate_frame_exact(gt[i][oid][0], o.vertices,
                                         o.keypoints, CAM_K)[1]
                    for i in range(n_frames)]).astype(np.float32)
                if verbose:
                    print(f"training kpd[obj {oid}] on occluded crops")
                kpd = train_kpd(train_u8, bboxes, parts, n_kp, kpd_iters,
                                kpd_finetune_iters, kpd_batch, inp_h, inp_w,
                                train_precision, seed=seed + 10 * oid,
                                verbose=verbose, beat=beat)
                ckpt.save_kpd_npz(kpath, kpd)
            weight_paths[oid] = (ypath, kpath)
        del train_u8

        # ---- SIXD tree of the HELD-OUT frames, both objects' GT per frame --
        base = work_dir or temp_dir("occl_mo_")
        rgb_dir = write_sixd_tree(base, objs, frames[n_frames:],
                                  gt[n_frames:])
        if verbose:
            print(f"SIXD tree with {n_eval} frames x {len(objs)} GT objects "
                  f"at {base}")

        # ---- the port's occlusion CLI, once per object ----
        from betapose_tpu_torch.eval import (
            occlusion_betapose_evaluate as occ_cli)

        def cli_hook(pipe):
            eval_hook(pipe, frames[n_frames:])

        def eval_all(extra_flags, tag=""):
            out = {}
            for oid in objs:
                ypath, kpath = weight_paths[oid]
                argv = [
                    "--indir", rgb_dir,
                    "--outdir", os.path.join(base, f"out_{oid:02d}"),
                    "--obj_id", str(oid),
                    "--sixd_base", base,
                    "--nClasses", str(n_kp),
                    "--left_keypoints", str(n_kp),
                    "--netType", "resnet50",
                    "--inp_dim", str(reso),
                    "--inputResH", str(inp_h), "--inputResW", str(inp_w),
                    "--outputResH", str(inp_h // 4), "--outputResW",
                    str(inp_w // 4),
                    "--detbatch", "8",
                    "--conf", "0.005",
                    # the occlusion recipe: multi-candidate device pose-NMS +
                    # score^4-weighted robust PnP
                    "--det_capacity", "4",
                    "--pnp_robust", "2",
                    "--pnp_score_power", "4",
                    "--yolo_weights", ypath,
                    "--kpd_weights", kpath,
                    "--device", str(dev),
                ] + extra_flags                 # later flags override earlier
                if verbose:
                    print(f"\n=== occlusion CLI, obj {oid}"
                          f"{' [' + tag + ']' if tag else ''} ===")
                out[oid] = occ_cli.main(
                    argv, eval_hook=cli_hook if eval_hook else None)
                if beat is not None:
                    beat()
            if verbose:
                print(f"\n{tag or 'default'}")
                print("obj  object   ADD<0.1d  2D<20px  IoU>0.5")
                for oid, o in objs.items():
                    r = out[oid]
                    print(f"{oid:02d}   {o.name:<8} {r['mean_add']:<9.2f} "
                          f"{r['mean_2d_acc']:<8.2f} {r['mean_iou']:<7.2f}")
            return out

        if not pnp_grid:
            return eval_all([])

        # ---- eval-side lever grid: same weights, same frames, PnP/pruning
        # knobs swept per combo ----
        results = {}
        for combo in pnp_grid:
            flags = []
            for k, v in combo.items():
                flags += [f"--{k}", str(v)]
            tag = ",".join(f"{k.replace('pnp_', '')}={v}"
                           for k, v in combo.items()) or "default"
            results[tag] = eval_all(flags, tag)
        return results


def parse_pnp_grid(spec: str):
    """--pnp_grid "k=v,k=v;k=v;default" -> list of flag dicts (semicolon-
    separated combos, comma-separated k=v; 'default' = empty combo)."""
    grid = []
    for part in spec.split(";"):
        part = part.strip()
        if not part or part == "default":
            grid.append({})
            continue
        combo = {}
        for kv in part.split(","):
            k, v = kv.split("=", 1)
            combo[k.strip()] = v.strip()
        grid.append(combo)
    return grid


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=800)
    p.add_argument("--eval_frames", type=int, default=32)
    p.add_argument("--yolo_iters", type=int, default=2000)
    p.add_argument("--kpd_iters", type=int, default=8000)
    p.add_argument("--kpd_finetune", type=int, default=3000)
    p.add_argument("--reso", type=int, default=416)
    p.add_argument("--params_dir", type=str, default=None)
    p.add_argument("--work_dir", type=str, default=None)
    p.add_argument("--train_precision", type=str, default=None,
                   choices=["bfloat16", "tensorfloat32", "float32"])
    p.add_argument("--out_json", type=str, default=None,
                   help="write the per-object result dict to this file")
    p.add_argument("--pnp_grid", type=str, default=None,
                   help="eval-only lever grid: semicolon-separated combos "
                        "of comma-separated flag=value (e.g. 'default;"
                        "pnp_spread_power=1;pnp_depth_prior=0.5,"
                        "left_keypoints=20'); reuses cached weights, "
                        "re-runs the occlusion CLI per combo")
    p.add_argument("--stall_timeout", type=float, default=900.0,
                   help="hard-exit (code 3) if no step/eval completes "
                        "for this many seconds; rerun to resume from "
                        "--params_dir caches.  0 disables")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda | cpu)")
    args = p.parse_args(argv)
    refuse_if_claimed("occl_multiobj")
    with StallWatchdog(args.stall_timeout, label="occl_multiobj",
                       yield_to=chip_claim_path()) as wd:
        out = run_occl_multiobj(
            n_frames=args.frames, n_eval=args.eval_frames,
            yolo_iters=args.yolo_iters, kpd_iters=args.kpd_iters,
            kpd_finetune_iters=args.kpd_finetune, reso=args.reso,
            params_dir=args.params_dir, work_dir=args.work_dir,
            train_precision=args.train_precision,
            pnp_grid=(parse_pnp_grid(args.pnp_grid)
                      if args.pnp_grid else None),
            beat=wd.beat if wd.enabled else None, device=args.device)
    if args.out_json:
        write_json_atomic(args.out_json,
                          dict({str(k): v for k, v in out.items()},
                               partial=False))
    return out


if __name__ == "__main__":
    main()
