"""darknet-compatible detector CLI, the part the port runs.

Counterpart of `betapose_tpu/tools/darknet_cli.py` (the vendored
darknet's `darknet.c:351` main -> `detector.c:1225` run_detector):

  python -m betapose_tpu_torch.tools.darknet_cli detector train  <data> <cfg> [weights] [-clear] [-gpus 0] [-resize_buckets 3] [-precision bfloat16|tensorfloat32|float32]
  python -m betapose_tpu_torch.tools.darknet_cli detector test   <data> <cfg> <weights> <image> [-thresh .24]
  python -m betapose_tpu_torch.tools.darknet_cli detector valid  <data> <cfg> <weights>
  python -m betapose_tpu_torch.tools.darknet_cli detector recall <data> <cfg> <weights>
  python -m betapose_tpu_torch.tools.darknet_cli detector map    <data> <cfg> <weights> [-iou_thresh .25]
  python -m betapose_tpu_torch.tools.darknet_cli detector demo   <data> <cfg> <weights> [video] [-out_filename o.avi] [-c 0] [-max_frames N] [-http_port 8090]
  python -m betapose_tpu_torch.tools.darknet_cli detector calc_anchors <data> -num_of_clusters 9 -width 416 -height 416

Every verb takes `-device cuda|cpu`, the port's own flag: CUDA unless it
says cpu (and an error without a card).  .data files are darknet's
key=value format (`option_list.c read_data_cfg`): classes/train/valid/
names/backup.  .cfg files are stock darknet network descriptions;
.weights files are byte-compatible with darknet's and the JAX package's
(`models/yolov3.py`).  The detection verbs run the folded network in its
bf16 layer (`models/yolov3.conv_bf16`: float32 sums, one rounding), on
the card and on the CPU alike.  `detector train ... -gpus 0,1,...`
trains data-parallel on as many ranks (`train/train_yolo_main`; CPU
processes with `-device cpu`).  The JAX CLI's other verbs raise:
they are not ported yet (`partial`: slice 5; the weight-surgery and
inspection verbs, `classifier`, `rnn` and `nightmare`: slice 7).
"""

from __future__ import annotations

import os
import sys

import numpy as np

# boolean flags take no value (darknet find_arg vs find_char_arg, utils.c)
BOOL_FLAGS = {"clear", "dont_show", "show", "tokenized"}

# the JAX CLI's verbs the port does not run yet, by ROADMAP slice
NOT_PORTED = {
    "partial": 5,
    "average": 7, "rescale": 7, "rgbgr": 7, "reset": 7, "denormalize": 7,
    "normalize": 7, "oneoff": 7, "statistics": 7, "visualize": 7,
    "imtest": 7, "speed": 7, "ops": 7, "classifier": 7, "rnn": 7,
    "nightmare": 7,
}


def read_data_cfg(path):
    """key=value parser (option_list.c:read_data_cfg)."""
    opts = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                opts[k.strip()] = v.strip()
    return opts


class CliError(int):
    """Error exit status distinguishable from data returns (frame counts,
    ratios) that happen to equal 1: the __main__ shim maps only CliError
    to a nonzero exit."""


def parse_flags(rest):
    """(positionals, {flag: value}) in darknet's flag syntax: '-name
    value', or '-name' alone for a boolean flag or at the end."""
    pos, flags = [], {}
    i = 0
    while i < len(rest):
        if rest[i].startswith("-"):
            name = rest[i].lstrip("-")
            if name in BOOL_FLAGS or i + 1 >= len(rest):
                flags[name] = ""
                i += 1
            else:
                flags[name] = rest[i + 1]
                i += 2
        else:
            pos.append(rest[i])
            i += 1
    return pos, flags


def _load_model(cfg_path, weights_path=None, device=None):
    """(folded network on `device`, reso).  An explicit weights path that
    does not resolve is an error: a typo must never evaluate a random
    init and print a plausible readout.  Without a path the verbs run a
    seeded random init (smoke mode), as darknet does."""
    import torch
    from ..core.device import resolve_device
    from ..models import yolov3 as yolo_mod
    dev = resolve_device(device)
    with open(cfg_path) as f:
        spec = yolo_mod.build_spec(f.read())
    reso = int(spec.net_info.get("width", 416))
    if weights_path and os.path.exists(weights_path):
        model, _ = yolo_mod.load_darknet_weights(spec, weights_path, reso)
        print(f"Loaded weights from {weights_path}")
    else:
        if weights_path:
            raise FileNotFoundError(f"weights {weights_path} not found")
        model = yolo_mod.Darknet(spec, reso, torch.Generator().manual_seed(0))
    return yolo_mod.fold_bn(model).to(dev), reso


def _infer(model, imgs01):
    """Decoded detections [B,rows,5+nC] (numpy float32) of float32 [B,reso,
    reso,3] images in [0,1]: rounded to bf16, then the bf16 network (the
    JAX CLI's `forward(x.astype(bfloat16))`)."""
    import torch
    dev = next(model.parameters()).device
    x = torch.from_numpy(np.ascontiguousarray(imgs01, np.float32)).to(dev)
    with torch.inference_mode():
        return model(x.to(torch.bfloat16)).float().cpu().numpy()


def _detect_images(model, reso, paths, thresh, nms_thresh=0.45, batch=16):
    """Run detection over images; returns per image an array of rows
    (x1,y1,x2,y2,score,cls) in original-image pixels (host NMS)."""
    import cv2
    from ..data.loader import imread_rgb
    results = []
    for start in range(0, len(paths), batch):
        imgs, dims = [], []
        for p in paths[start:start + batch]:
            im = imread_rgb(p)
            dims.append(im.shape[:2])
            imgs.append(cv2.resize(im, (reso, reso)).astype(np.float32) / 255)
        preds = _infer(model, np.stack(imgs))
        results.extend(
            _postprocess_dets(preds, dims, reso, thresh, nms_thresh))
    return results


def _postprocess_dets(preds, dims, reso, thresh, nms_thresh):
    """Decoded predictions [B,rows,5+nC] -> per-image (x1,y1,x2,y2,score,
    cls) arrays in original-image pixels (confidence gate + host NMS)."""
    out = []
    for bi, (h0, w0) in enumerate(dims):
        p = preds[bi]
        dets = p[p[:, 4] > thresh]
        if len(dets) == 0:
            out.append(np.zeros((0, 6)))
            continue
        cls_score = dets[:, 5:].max(axis=1) * dets[:, 4]
        cls_id = dets[:, 5:].argmax(axis=1)
        boxes = np.stack([
            (dets[:, 0] - dets[:, 2] / 2) * w0 / reso,
            (dets[:, 1] - dets[:, 3] / 2) * h0 / reso,
            (dets[:, 0] + dets[:, 2] / 2) * w0 / reso,
            (dets[:, 1] + dets[:, 3] / 2) * h0 / reso], axis=1)
        order = np.argsort(-cls_score)
        boxes, cls_score, cls_id = boxes[order], cls_score[order], cls_id[order]
        keep_idx = _greedy_nms(boxes, cls_score, cls_id, nms_thresh)
        out.append(np.concatenate(
            [boxes[keep_idx], cls_score[keep_idx, None],
             cls_id[keep_idx, None].astype(np.float64)], axis=1))
    return out


def _greedy_nms(boxes, scores, cls_id, thresh):
    keep = []
    alive = np.ones(len(boxes), bool)
    for i in range(len(boxes)):
        if not alive[i]:
            continue
        keep.append(i)
        for j in range(i + 1, len(boxes)):
            if alive[j] and cls_id[j] == cls_id[i]:
                if _iou_xyxy(boxes[i], boxes[j]) > thresh:
                    alive[j] = False
    return np.asarray(keep, int)


def _iou_xyxy(a, b):
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    if x2 <= x1 or y2 <= y1:
        return 0.0
    inter = (x2 - x1) * (y2 - y1)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua


def _label_path(p):
    """replace_image_to_label (utils.c:225): the sibling .txt, with the
    images/ -> labels/ convention as the fallback."""
    txt = os.path.splitext(p)[0] + ".txt"
    if not os.path.exists(txt):
        txt = p.replace("images", "labels").rsplit(".", 1)[0] + ".txt"
    return txt


def _load_gt(paths):
    """Ground truth from the label files, in pixels per image: rows
    (x1,y1,x2,y2,cls)."""
    import cv2
    gts = []
    for p in paths:
        txt = _label_path(p)
        h0, w0 = cv2.imread(p).shape[:2]
        rows = []
        if os.path.exists(txt):
            for ln in open(txt):
                v = ln.split()
                if len(v) >= 5:
                    cls, cx, cy, w, h = (float(t) for t in v[:5])
                    rows.append([(cx - w / 2) * w0, (cy - h / 2) * h0,
                                 (cx + w / 2) * w0, (cy + h / 2) * h0, cls])
        gts.append(np.asarray(rows).reshape(-1, 5))
    return gts


def _names(opts, default_count=None):
    if "names" in opts and os.path.exists(opts["names"]):
        return [ln.strip() for ln in open(opts["names"])]
    return ([str(i) for i in range(default_count)]
            if default_count is not None else [])


def _list(opts, key):
    return [ln.strip() for ln in open(opts[key]) if ln.strip()]


def cmd_map(data, cfg, weights, iou_thresh=0.25, thresh=0.005, device=None):
    """validate_detector_map (`detector.c:556`): VOC-style AP per class at
    the given IoU threshold over the valid list."""
    opts = read_data_cfg(data)
    paths = _list(opts, "valid")
    n_classes = int(opts.get("classes", 1))
    model, reso = _load_model(cfg, weights, device=device)
    dets = _detect_images(model, reso, paths, thresh)
    gts = _load_gt(paths)

    aps = []
    for c in range(n_classes):
        records = []  # (score, is_tp)
        n_gt = 0
        for det, gt in zip(dets, gts):
            gt_c = gt[gt[:, 4] == c]
            n_gt += len(gt_c)
            used = np.zeros(len(gt_c), bool)
            for d in det[det[:, 5] == c]:
                best, bi = 0.0, -1
                for gi, g in enumerate(gt_c):
                    i = _iou_xyxy(d[:4], g[:4])
                    if i > best:
                        best, bi = i, gi
                tp = best > iou_thresh and bi >= 0 and not used[bi]
                if tp:
                    used[bi] = True
                records.append((d[4], tp))
        if n_gt == 0:
            continue
        records.sort(key=lambda r: -r[0])
        tps = np.cumsum([r[1] for r in records]) if records else np.array([])
        fps = (np.cumsum([not r[1] for r in records]) if records
               else np.array([]))
        rec = tps / n_gt if len(tps) else np.array([0.0])
        prec = (tps / np.maximum(tps + fps, 1e-12) if len(tps)
                else np.array([0.0]))
        ap = 0.0
        for t in np.arange(0, 1.01, 0.1):  # 11-point VOC AP
            p = prec[rec >= t].max() if np.any(rec >= t) else 0.0
            ap += p / 11
        aps.append(ap)
        print(f"class {c}: ap = {ap * 100:.2f}%")
    mean_ap = float(np.mean(aps)) if aps else 0.0
    print(f"mean average precision (mAP@{iou_thresh:.2f}) = {mean_ap:.6f}, "
          f"or {mean_ap * 100:.2f}%")
    return mean_ap


def cmd_recall(data, cfg, weights, thresh=0.001, iou_thresh=0.5,
               device=None):
    """validate_detector_recall (`detector.c:461`): proposals, avg IoU,
    recall over the valid list."""
    opts = read_data_cfg(data)
    paths = _list(opts, "valid")
    model, reso = _load_model(cfg, weights, device=device)
    dets = _detect_images(model, reso, paths, thresh)
    gts = _load_gt(paths)
    total, correct, proposals, iou_sum = 0, 0, 0, 0.0
    for i, (det, gt) in enumerate(zip(dets, gts)):
        proposals += len(det)
        for g in gt:
            total += 1
            best = max((_iou_xyxy(d[:4], g[:4]) for d in det), default=0.0)
            iou_sum += best
            if best > iou_thresh:
                correct += 1
        print(f"{i:5d} {correct:5d} {total:5d}\tRPs/Img: "
              f"{proposals / (i + 1):.2f}\tIOU: "
              f"{iou_sum / max(total, 1) * 100:.2f}%\tRecall:"
              f"{correct / max(total, 1) * 100:.2f}%")
    return correct / max(total, 1)


def cmd_demo(data, cfg, weights, video=None, thresh=0.24, nms_thresh=0.45,
             out_filename=None, batch=8, webcam="0", max_frames=None,
             http_port=None, device=None):
    """`detector demo` (`detector.c:1287-1297` -> demo.c): the detector over
    a video file (or a webcam when no file is given), printing each
    frame's detections, optionally writing an overlay video
    (`-out_filename`) and serving the overlay frames as an MJPEG stream
    (`-http_port`, `detector.c:1230` -> http_stream.cpp).  max_frames
    bounds the loop (darknet runs until a keypress).  One frame out per
    video frame: the padded tail of the last batch is dropped.  Returns
    the frame count."""
    import cv2
    from ..data.video import VideoLoader, VideoWriter, WebcamLoader

    names = _names(read_data_cfg(data))
    model, reso = _load_model(cfg, weights, device=device)

    def detect_batch(frames_rgb):
        x = np.stack([cv2.resize(f, (reso, reso)) for f in frames_rgb]
                     ).astype(np.float32) / 255.0
        dims = [f.shape[:2] for f in frames_rgb]
        return _postprocess_dets(_infer(model, x), dims, reso, thresh,
                                 nms_thresh)

    writer = None
    streamer = None
    if http_port is not None:
        from .http_stream import MjpegStreamer
        streamer = MjpegStreamer(int(http_port))
        print(f"MJPEG stream on http://0.0.0.0:{streamer.port}/")
    n_frames = 0
    n_dets = 0

    def emit(frame_rgb, dets):
        nonlocal n_frames, n_dets
        n_frames += 1
        n_dets += len(dets)
        for d in dets:
            cname = (names[int(d[5])] if int(d[5]) < len(names)
                     else str(int(d[5])))
            print(f"frame {n_frames}: {cname} {d[4]:.3f} "
                  f"[{d[0]:.0f},{d[1]:.0f},{d[2]:.0f},{d[3]:.0f}]")
        if writer is not None or streamer is not None:
            img = frame_rgb.copy()
            for d in dets:
                cv2.rectangle(img, (int(d[0]), int(d[1])),
                              (int(d[2]), int(d[3])), (60, 255, 120), 2)
            if writer is not None:
                writer.write_rgb(img)
            if streamer is not None:
                streamer.write_rgb(img)

    try:
        if video:
            loader = VideoLoader(video, batch_size=batch)
            if out_filename:
                _, fps, size = loader.videoinfo()
                writer = VideoWriter(out_filename, fps or 25, size)
            for frames in loader:
                frames = list(frames[:loader.n_real])
                for f, dets in zip(frames, detect_batch(frames)):
                    emit(f, dets)
                    if max_frames and n_frames >= max_frames:
                        break
                if max_frames and n_frames >= max_frames:
                    break
        else:
            cam = WebcamLoader(webcam)
            try:
                while max_frames is None or n_frames < max_frames:
                    frame = cam.read()
                    emit(frame, detect_batch([frame])[0])
            finally:
                cam.stop()
    finally:
        if writer is not None:
            writer.release()
        if streamer is not None:
            streamer.close()
    print(f"demo: {n_frames} frames, {n_dets} detections")
    return n_frames


def cmd_test(data, cfg, weights, image, thresh=0.24, device=None):
    """test_detector (`detector.c:1100`): print the detections of one
    image; returns them."""
    names = _names(read_data_cfg(data))
    model, reso = _load_model(cfg, weights, device=device)
    dets = _detect_images(model, reso, [image], thresh)[0]
    for d in dets:
        cname = names[int(d[5])] if int(d[5]) < len(names) else str(int(d[5]))
        print(f"{cname}: {d[4] * 100:.0f}%  box "
              f"[{d[0]:.0f}, {d[1]:.0f}, {d[2]:.0f}, {d[3]:.0f}]")
    return dets


def cmd_valid(data, cfg, weights, thresh=0.005, out_dir="results",
              device=None):
    """validate_detector: the detections of the valid list in comp4-style
    text files under `out_dir` (darknet writes results/); returns them."""
    opts = read_data_cfg(data)
    paths = _list(opts, "valid")
    names = _names(opts, int(opts.get("classes", 1)))
    model, reso = _load_model(cfg, weights, device=device)
    dets = _detect_images(model, reso, paths, thresh)
    os.makedirs(out_dir, exist_ok=True)
    files = {c: open(os.path.join(
        out_dir, f"comp4_det_test_{names[c]}.txt"), "w")
        for c in range(len(names))}
    for p, det in zip(paths, dets):
        image_id = os.path.splitext(os.path.basename(p))[0]
        for d in det:
            files[int(d[5])].write(
                f"{image_id} {d[4]:.6f} {d[0] + 1:.6f} "
                f"{d[1] + 1:.6f} {d[2] + 1:.6f} {d[3] + 1:.6f}\n")
    for f in files.values():
        f.close()
    print(f"{out_dir}/ written")
    return dets


def cmd_calc_anchors(data, num_of_clusters=5, width=-1, height=-1,
                     out_file="anchors.txt"):
    """`detector calc_anchors` (detector.c calc_anchors():905): k-means++
    (10 attempts, the cvKMeans2 call as cv2.kmeans) over every GT box's
    (w*width, h*height) in network-input pixels; centers sorted by area
    (anchors_comparator:895); prints the avg IoU of each box against its
    nearest-by-Euclidean anchor and writes `anchors.txt` as 'w,h, w,h,
    ...'.  The reference's -show scatter window is GUI-only, left out."""
    import cv2
    print(f"\n num_of_clusters = {num_of_clusters}, width = {width}, "
          f"height = {height} ")
    if width < 0 or height < 0:
        print("Usage: darknet detector calc_anchors data/voc.data "
              "-num_of_clusters 9 -width 416 -height 416 \n"
              "Error: set width and height ")
        return CliError(1)
    paths = _list(read_data_cfg(data), "train")
    print(f" read labels from {len(paths)} images ")
    wh = []
    for p in paths:
        txt = _label_path(p)
        if not os.path.exists(txt):
            continue
        for j, ln in enumerate(open(txt)):
            vals = ln.split()
            if len(vals) < 5:
                continue
            _, x, y, w, h = (float(v) for v in vals[:5])
            if not (0 < x <= 1 and 0 < y <= 1 and 0 < w <= 1 and 0 < h <= 1):
                print(f"\n\nWrong label: {txt} - j = {j}, x = {x:f}, "
                      f"y = {y:f}, width = {w:f}, height = {h:f} ")
                continue
            wh.append((w * width, h * height))
    n_boxes = len(wh)
    print(" all loaded. ")
    if n_boxes < num_of_clusters:
        print(f"Error: only {n_boxes} boxes for {num_of_clusters} clusters")
        return CliError(1)
    points = np.asarray(wh, np.float32)
    print("\n calculating k-means++ ...")
    cv2.setRNGSeed(12345)
    _, _, centers = cv2.kmeans(
        points, num_of_clusters, None,
        (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 10000, 0.0),
        attempts=10, flags=cv2.KMEANS_PP_CENTERS)
    centers = centers[np.argsort(centers[:, 0] * centers[:, 1])]

    # the avg IoU readout takes the nearest center by Euclidean distance
    # (the reference's choice; detector.c:980 notes 1-IoU would be right)
    d2 = ((points[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    nearest = centers[np.argmin(d2, axis=1)]
    mins = np.minimum(points, nearest)
    inter = mins[:, 0] * mins[:, 1]
    union = (points[:, 0] * points[:, 1]
             + nearest[:, 0] * nearest[:, 1] - inter)
    avg_iou = 100.0 * float((inter / union).mean())
    print(f"\n avg IoU = {avg_iou:2.2f} % ")
    anchors = ", ".join(f"{w:2.4f},{h:2.4f}" for w, h in centers)
    with open(out_file, "w") as f:
        f.write(anchors)
    print(f"\nSaving anchors to the file: {out_file} ")
    print(f"anchors = {anchors}")
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else CliError(1)
    if argv[0] in NOT_PORTED:
        raise NotImplementedError(
            f"darknet_cli {argv[0]}: not ported yet (ROADMAP slice "
            f"{NOT_PORTED[argv[0]]}); the port runs the detector verbs")
    if len(argv) < 2 or argv[0] != "detector":
        print(__doc__)
        return CliError(1)
    verb = argv[1]
    pos, flags = parse_flags(argv[2:])
    device = flags.get("device") or None
    if verb == "train":
        if len(pos) < 2:
            print(__doc__)
            return CliError(1)
        from ..train.train_yolo_main import train_from_data_cfg
        return train_from_data_cfg(
            pos[0], pos[1], pos[2] if len(pos) > 2 else None,
            clear="clear" in flags,
            n_devices=len(flags.get("gpus", "0").split(",")),
            # the static analog of darknet's per-10-iteration random resize
            resize_buckets=int(flags.get("resize_buckets", 3)),
            precision=flags.get("precision"), device=device)
    if verb == "calc_anchors":
        return cmd_calc_anchors(
            pos[0], num_of_clusters=int(flags.get("num_of_clusters", 5)),
            width=int(flags.get("width", -1)),
            height=int(flags.get("height", -1)))
    if verb == "map":
        return cmd_map(pos[0], pos[1], pos[2],
                       iou_thresh=float(flags.get("iou_thresh", 0.25)),
                       device=device)
    if verb == "recall":
        return cmd_recall(pos[0], pos[1], pos[2], device=device)
    if verb == "valid":
        return cmd_valid(pos[0], pos[1], pos[2], device=device)
    if verb == "test":
        return cmd_test(pos[0], pos[1], pos[2], pos[3],
                        thresh=float(flags.get("thresh", 0.24)),
                        device=device)
    if verb == "demo":
        return cmd_demo(pos[0], pos[1], pos[2],
                        video=pos[3] if len(pos) > 3 else None,
                        thresh=float(flags.get("thresh", 0.24)),
                        out_filename=flags.get("out_filename"),
                        webcam=flags.get("c", "0"),
                        max_frames=int(flags["max_frames"])
                        if "max_frames" in flags else None,
                        http_port=int(flags["http_port"])
                        if "http_port" in flags else None, device=device)
    print(f"unknown verb {verb}")
    return CliError(1)


if __name__ == "__main__":
    # a completed verb exits 0 whatever it returns (a demo of N frames must
    # not exit N); only CliError maps to a nonzero exit
    out = main()
    raise SystemExit(1 if isinstance(out, CliError) else 0)
