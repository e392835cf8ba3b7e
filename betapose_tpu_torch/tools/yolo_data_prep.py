"""YOLO training-data preparation: SIXD gt.yml -> darknet txt labels.

Counterpart of `train_YOLO/scripts/{gt_,}single_object.py` and
`{gt_,}multi_object.py`: sample a ratio of each sequence's frames (GT_RATIO
0.1 in the gt_ variants), copy images, write one normalized
'class cx cy w h' label line per object, and emit the .data/.names/list
files the darknet-compatible trainer consumes.

Conventions preserved: LineMod 640x480; class id 0 for single-object
configs, (seq-1) for the 15-class multi-object config; the same
LineMod class-name table.

Usage:
  python -m betapose_tpu_torch.tools.yolo_data_prep --sixd_base <sixd>/test \
      --out ./data_linemod --mode single --ratio 0.1 [--val]
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np
import yaml

CLASS_NAMES = ("ape", "bvise", "bowl", "camera", "can", "cat", "cup",
               "driller", "duck", "eggbo", "glue", "holepuncher", "iron",
               "lamp", "phone")
WIDTH, HEIGHT = 640, 480
NUM_SEQS = 15


def write_labels_for_seq(sixd_test, out_dir, seq: int, ratio: float,
                         class_id: int, rng, copy_images=True):
    """Returns the list of (copied) image paths with sibling .txt labels."""
    seq_s = "%02d" % seq
    rgb_dir = os.path.join(sixd_test, seq_s, "rgb")
    img_out = os.path.join(out_dir, seq_s, "images")
    os.makedirs(img_out, exist_ok=True)
    with open(os.path.join(sixd_test, seq_s, "gt.yml")) as f:
        gt_info = yaml.safe_load(f)

    paths = []
    for img in sorted(os.listdir(rgb_dir)):
        if rng.random() >= ratio:
            continue
        src = os.path.join(rgb_dir, img)
        dst = os.path.join(img_out, img)
        if copy_images:
            shutil.copyfile(src, dst)
        else:
            dst = src
        paths.append(dst)
        frame_idx = int(os.path.splitext(img)[0])
        lines = []
        for gt in gt_info[frame_idx]:
            bb = list(gt["obj_bb"])
            cx = (bb[0] + bb[2] / 2) / WIDTH
            cy = (bb[1] + bb[3] / 2) / HEIGHT
            w = bb[2] / WIDTH
            h = bb[3] / HEIGHT
            cid = class_id if class_id >= 0 else int(gt["obj_id"]) - 1
            lines.append(f"{cid} {cx:f} {cy:f} {w:f} {h:f}\n")
        with open(os.path.splitext(dst)[0] + ".txt", "w") as f:
            f.writelines(lines)
    return paths


def prep_single(sixd_test, out_dir, ratio=0.1, seed=0):
    """One single-class dataset per sequence (gt_single_object.py)."""
    rng = np.random.default_rng(seed)
    for seq in range(1, NUM_SEQS + 1):
        seq_s = "%02d" % seq
        name = CLASS_NAMES[seq - 1]
        if not os.path.exists(os.path.join(sixd_test, seq_s)):
            continue
        paths = write_labels_for_seq(sixd_test, out_dir, seq, ratio, 0, rng)
        seq_dir = os.path.join(out_dir, seq_s)
        with open(os.path.join(seq_dir, "all.txt"), "w") as f:
            f.writelines(p + "\n" for p in paths)
        with open(os.path.join(seq_dir, name + ".names"), "w") as f:
            f.write(name + "\n")
        with open(os.path.join(seq_dir, name + ".data"), "w") as f:
            f.write("classes = 1\n")
            f.write(f"train = {os.path.join(seq_dir, 'all.txt')}\n")
            f.write(f"valid = {os.path.join(seq_dir, 'all.txt')}\n")
            f.write(f"names = {os.path.join(seq_dir, name + '.names')}\n")
            f.write(f"backup = {os.path.join(seq_dir, 'backup')}\n")
        print(f"seq {seq_s}: {len(paths)} frames")


def prep_multi(sixd_test, out_dir, ratio=0.1, seed=0):
    """One 15-class dataset over all sequences (gt_multi_object.py /
    yolo-linemod.cfg)."""
    rng = np.random.default_rng(seed)
    all_paths = []
    for seq in range(1, NUM_SEQS + 1):
        seq_s = "%02d" % seq
        if not os.path.exists(os.path.join(sixd_test, seq_s)):
            continue
        all_paths += write_labels_for_seq(
            sixd_test, out_dir, seq, ratio, -1, rng)
    with open(os.path.join(out_dir, "all.txt"), "w") as f:
        f.writelines(p + "\n" for p in all_paths)
    with open(os.path.join(out_dir, "linemod.names"), "w") as f:
        f.writelines(n + "\n" for n in CLASS_NAMES)
    with open(os.path.join(out_dir, "linemod.data"), "w") as f:
        f.write(f"classes = {NUM_SEQS}\n")
        f.write(f"train = {os.path.join(out_dir, 'all.txt')}\n")
        f.write(f"valid = {os.path.join(out_dir, 'all.txt')}\n")
        f.write(f"names = {os.path.join(out_dir, 'linemod.names')}\n")
        f.write(f"backup = {os.path.join(out_dir, 'backup')}\n")
    print(f"multi: {len(all_paths)} frames")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sixd_base", required=True,
                   help="<sixd>/test directory")
    p.add_argument("--out", required=True)
    p.add_argument("--mode", choices=["single", "multi"], default="single")
    p.add_argument("--ratio", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.mode == "single":
        prep_single(args.sixd_base, args.out, args.ratio, args.seed)
    else:
        prep_multi(args.sixd_base, args.out, args.ratio, args.seed)


if __name__ == "__main__":
    main()
