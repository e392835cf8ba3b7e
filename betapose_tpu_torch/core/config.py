"""Typed configuration tree + reference-compatible CLI flags.

The reference carries four divergent argparse `opt` modules consumed by
import side-effect (`3_6Dpose_estimator/opt.py:1-150`, `train_KPD/src/opt.py`,
`KPD/src/opt.py`, `2_keypoint_annotator/opt.py`).  Here there is exactly ONE
canonical config tree (SURVEY.md 2.10), with `make_parser()` exposing the
reference flag surface (same flag names / dests / defaults) so existing
command lines keep working, and `Config.from_args` materializing the typed
tree.  Flag defaults follow the main eval copy; the eval-path constants are
the canonical ones.

A copy of the JAX package's `core/config.py` (the port imports nothing of
that package) with one addition: `--device` (default `cuda`).
"""

from __future__ import annotations

import argparse
import dataclasses


@dataclasses.dataclass
class ModelConfig:
    net_type: str = "resnet101"       # FastPose backbone (or 'hgPRM')
    n_classes: int = 50               # keypoint channels
    n_feats: int = 256
    n_stack: int = 4
    fast_inference: bool = True
    inp_dim: int = 416                # YOLO input resolution
    input_res_h: int = 320            # KPD crop H
    input_res_w: int = 256            # KPD crop W
    output_res_h: int = 80            # KPD heatmap H
    output_res_w: int = 64            # KPD heatmap W


@dataclasses.dataclass
class DetectionConfig:
    confidence: float = 0.01          # objectness threshold (opt.py:126)
    nms_thresh: float = 0.6           # (opt.py:128) — best-box path ignores it
    det_batch: int = 1
    pose_batch: int = 80
    num_classes: int = 80             # opt.num_classes = 80 (opt.py:150)
    preproc: str = "stretch"          # 'stretch' | 'letterbox'
    det_capacity: int = 1             # boxes/frame; >1 enables the
    #                                 # multi-candidate pose-NMS path
    host_pose_nms: bool = False       # multi-candidate clustering on host
    #                                 # (reference-style loop) vs on device
    pnp_robust: int = 0               # trimmed-IRLS robust-PnP rounds
    #                                 # (0 = reference least-squares)
    pnp_score_power: float = 0.0      # >0: weight PnP correspondences by
    #                                 # clip(kp_score,0)**power (extension)
    pnp_spread_power: float = 0.0     # >0: also weight by heatmap peak
    #                                 # CONCENTRATION**power (extension)
    pnp_depth_prior: float = 0.0      # >0: soft bbox-scale depth prior
    #                                 # weight in the LM solve (extension)


@dataclasses.dataclass
class TrainConfig:
    lr: float = 2.5e-4
    momentum: float = 0.0
    weight_decay: float = 0.0
    opt_method: str = "rmsprop"       # rmsprop | adam | sgd
    n_epochs: int = 200
    train_batch: int = 40
    valid_batch: int = 20
    snapshot: int = 1
    add_dpg: bool = False
    scale: float = 0.25
    rotate: float = 30.0
    hm_gauss: int = 1
    crit: str = "MSE"


@dataclasses.dataclass
class RuntimeConfig:
    profile: bool = False
    sp: bool = True                   # single-process (informational)
    n_threads: int = 40
    save_img: bool = False
    vis: bool = False
    format: str | None = None         # coco | cmu | open
    input_path: str = ""
    input_list: str = ""
    output_path: str = "examples/res/"
    video: str = ""
    webcam: str = "0"
    save_video: bool = False
    host_loader: str = "auto"         # auto | native | threads | procs
    device: str = "cuda"              # torch device the pipeline runs on


@dataclasses.dataclass
class Config:
    obj_id: int = 5
    left_keypoints: int = 10
    exp_id: str = "default"
    dataset: str = "coco"
    # objects graded with ADD-S (closest-vertex) instead of plain ADD —
    # LineMod's symmetric pair eggbox (10) / glue (11) by convention; the
    # reference carries adds_err only commented out (utils/metrics.py:23-33)
    # so its eggbox/glue numbers use the wrong metric
    sym_objects: frozenset = frozenset({10, 11})
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    detection: DetectionConfig = dataclasses.field(default_factory=DetectionConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "Config":
        c = cls()
        c.obj_id = args.obj_id
        c.left_keypoints = args.left_keypoints
        sym = getattr(args, "sym_objects", "10,11")
        c.sym_objects = frozenset(
            int(v) for v in str(sym).split(",") if v.strip())
        c.exp_id = args.expID
        c.dataset = args.dataset
        m = c.model
        m.net_type = args.netType
        m.n_classes = args.nClasses
        m.n_feats = args.nFeats
        m.n_stack = args.nStack
        m.fast_inference = args.fast_inference
        m.inp_dim = int(args.inp_dim)
        m.input_res_h = args.inputResH
        m.input_res_w = args.inputResW
        m.output_res_h = args.outputResH
        m.output_res_w = args.outputResW
        d = c.detection
        d.confidence = args.confidence
        d.nms_thresh = args.nms_thesh
        d.det_batch = args.detbatch
        d.det_capacity = getattr(args, "det_capacity", 1)
        d.host_pose_nms = getattr(args, "host_pose_nms", False)
        d.pnp_robust = getattr(args, "pnp_robust", 0)
        d.pnp_score_power = getattr(args, "pnp_score_power", 0.0)
        d.pnp_spread_power = getattr(args, "pnp_spread_power", 0.0)
        d.pnp_depth_prior = getattr(args, "pnp_depth_prior", 0.0)
        d.pose_batch = args.posebatch
        t = c.train
        t.lr = args.LR
        t.momentum = args.momentum
        t.weight_decay = args.weightDecay
        t.opt_method = args.optMethod
        t.n_epochs = args.nEpochs
        t.train_batch = args.trainBatch
        t.valid_batch = args.validBatch
        t.snapshot = args.snapshot
        t.add_dpg = bool(args.addDPG)
        t.scale = args.scale
        t.rotate = args.rotate
        t.hm_gauss = args.hmGauss
        t.crit = args.crit
        r = c.runtime
        r.profile = args.profile
        r.sp = args.sp
        r.n_threads = args.nThreads
        r.save_img = args.save_img
        r.vis = args.vis
        r.format = args.format
        r.input_path = args.inputpath
        r.input_list = args.inputlist
        r.output_path = args.outputpath
        r.video = args.video
        r.webcam = args.webcam
        r.save_video = args.save_video
        r.host_loader = getattr(args, "host_loader", "auto")
        r.device = getattr(args, "device", "cuda")
        return c


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "1", "yes", "y"):
        return True
    if v.lower() in ("false", "0", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"boolean expected, got {v!r}")


def make_parser(description: str = "Betapose (PyTorch)") -> argparse.ArgumentParser:
    """The reference CLI surface (`3_6Dpose_estimator/opt.py`), flag-for-flag."""
    p = argparse.ArgumentParser(description=description)
    # General
    p.add_argument("--expID", default="default", type=str)
    p.add_argument("--dataset", default="coco", type=str)
    p.add_argument("--nThreads", default=40, type=int)
    p.add_argument("--left_keypoints", default=10, type=int,
                   help="Number of keypoints left in PnP algorithm.")
    p.add_argument("--debug", default=False, type=bool)
    p.add_argument("--snapshot", default=1, type=int)
    p.add_argument("--obj_id", default=5, type=int)
    # AlphaPose
    p.add_argument("--addDPG", default=False, type=bool)
    p.add_argument("--sp", default=False, action="store_true")
    p.add_argument("--profile", default=False, action="store_true")
    # Model
    p.add_argument("--netType", default="resnet101", type=str)
    p.add_argument("--loadModel", default=None, type=str)
    p.add_argument("--Continue", default=False, type=bool)
    p.add_argument("--nFeats", default=256, type=int)
    p.add_argument("--nClasses", default=50, type=int)
    p.add_argument("--nStack", default=4, type=int)
    # reference opt.py:45 uses type=bool, where '--fast_inference False'
    # parses as bool('False') == True — the flag could literally never be
    # turned off (masking that InferenNet didn't exist).  Here it parses
    # properly and False routes the fused pipeline through flip-TTA.
    p.add_argument("--fast_inference", default=True, type=_str2bool)
    p.add_argument("--use_pyranet", default=True, type=bool)
    # Hyperparams
    p.add_argument("--LR", default=2.5e-4, type=float)
    p.add_argument("--momentum", default=0, type=float)
    p.add_argument("--weightDecay", default=0, type=float)
    p.add_argument("--crit", default="MSE", type=str)
    p.add_argument("--optMethod", default="rmsprop", type=str)
    # Training
    p.add_argument("--nEpochs", default=200, type=int)
    p.add_argument("--epoch", default=0, type=int)
    p.add_argument("--trainBatch", default=40, type=int)
    p.add_argument("--validBatch", default=20, type=int)
    p.add_argument("--trainIters", default=0, type=int)
    p.add_argument("--valIters", default=0, type=int)
    p.add_argument("--init", default=None, type=str)
    # Data
    p.add_argument("--inputResH", default=320, type=int)
    p.add_argument("--inputResW", default=256, type=int)
    p.add_argument("--outputResH", default=80, type=int)
    p.add_argument("--outputResW", default=64, type=int)
    p.add_argument("--scale", default=0.25, type=float)
    p.add_argument("--rotate", default=30, type=float)
    p.add_argument("--hmGauss", default=1, type=int)
    # PyraNet
    p.add_argument("--baseWidth", default=9, type=int)
    p.add_argument("--cardinality", default=5, type=int)
    p.add_argument("--nResidual", default=1, type=int)
    # Distribution (vestigial in reference; mesh config here)
    p.add_argument("--dist", dest="dist", type=int, default=1)
    p.add_argument("--backend", dest="backend", type=str, default="gloo")
    p.add_argument("--port", dest="port")
    # Detection
    p.add_argument("--net", dest="demo_net", default="res152")
    p.add_argument("--indir", dest="inputpath", default="")
    p.add_argument("--list", dest="inputlist", default="")
    p.add_argument("--mode", dest="mode", default="normal")
    p.add_argument("--outdir", dest="outputpath", default="examples/res/")
    p.add_argument("--inp_dim", dest="inp_dim", type=str, default="416")
    p.add_argument("--conf", dest="confidence", type=float, default=0.01)
    p.add_argument("--nms", dest="nms_thesh", type=float, default=0.6)
    p.add_argument("--det_capacity", type=int, default=1,
                   help="max detections kept per frame; >1 routes crowded "
                        "scenes through the full parametric pose-NMS "
                        "(extension; 1 = reference best-box)")
    p.add_argument("--host_pose_nms", action="store_true",
                   help="with --det_capacity>1: run the pose-NMS cluster "
                        "loop host-side (reference DataWriter-style) "
                        "instead of the fused on-device fixed-trip loop")
    p.add_argument("--pnp_robust", type=int, default=0,
                   help="trimmed-IRLS robust-PnP rounds (extension; "
                        "0 = reference least-squares PnP)")
    p.add_argument("--pnp_score_power", type=float, default=0.0,
                   help="weight PnP correspondences by keypoint-score**p "
                        "(extension; 0 = unweighted; pairs well "
                        "with --pnp_robust under occlusion)")
    p.add_argument("--pnp_spread_power", type=float, default=0.0,
                   help="also weight PnP correspondences by heatmap peak "
                        "concentration**p (extension; punishes "
                        "hedging/multimodal responses whose peak VALUE "
                        "is still high; 0 = off)")
    p.add_argument("--pnp_depth_prior", type=float, default=0.0,
                   help="soft depth prior weight: pull PnP t_z toward "
                        "f*diameter/max(box_w,box_h) in the LM solve "
                        "(extension; 0 = off)")
    p.add_argument("--host_loader", type=str, default="auto",
                   choices=("auto", "native", "threads", "procs"),
                   help="host frame-decode backend: native = C++ "
                        "threaded libpng/libjpeg ring loader (raises when "
                        "it cannot build), threads/procs = Python cv2 "
                        "pools, auto = native when it builds and the "
                        "inputs are PNG/JPEG, else threads")
    p.add_argument("--save_img", default=False, action="store_true")
    p.add_argument("--vis", default=False, action="store_true")
    p.add_argument("--format", type=str)
    p.add_argument("--detbatch", type=int, default=1)
    p.add_argument("--posebatch", type=int, default=80)
    # Video
    p.add_argument("--video", dest="video", default="")
    p.add_argument("--webcam", dest="webcam", type=str, default="0")
    p.add_argument("--save_video", dest="save_video", default=False,
                   action="store_true")
    p.add_argument("--vis_fast", dest="vis_fast", action="store_true",
                   default=False)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device to run the pipeline on (cuda | cpu); "
                        "cuda raises when no CUDA device is present")
    # Betapose extras
    p.add_argument("--sym_objects", default="10,11", type=str,
                   help="comma-separated obj_ids graded with ADD-S "
                        "(closest-vertex distance) instead of plain ADD — "
                        "default LineMod's symmetric eggbox/glue (10,11); "
                        "'' disables (reference behavior: ADD everywhere, "
                        "its adds_err is commented out, utils/metrics.py:23)")
    p.add_argument("--sixd_base", default="/media/data_2/SIXD/hinterstoisser",
                   type=str, help="SIXD/LineMod dataset root")
    p.add_argument("--yolo_weights", default=None, type=str,
                   help="darknet .weights path (default models/yolo/{obj:02d}.weights)")
    p.add_argument("--yolo_cfg", default=None, type=str,
                   help="darknet cfg path (default: generated single-class yolov3)")
    p.add_argument("--kpd_weights", default=None, type=str,
                   help="KPD checkpoint (.pkl torch state_dict or .npz pytree)")
    p.add_argument("--preproc", default="stretch", choices=["stretch", "letterbox"],
                   help="YOLO input geometry (reference trains/rescales in stretch)")
    return p
