"""KPD training CLI.

Counterpart of `betapose_tpu/train/train_kpd_main.py` (reference
`train_KPD/src/train.py`), with the same flags (`--expID --nClasses
--netType --optMethod --trainBatch --addDPG --loadModel --Continue
--nEpochs --snapshot --trainPrecision --symPerms ...`) plus `--device`:
the host decodes PNGs, the augmentation runs batched on the device
(`train/augment.py`), the train step is `train/kpd_train.py`'s.  The
experiment layout is the JAX package's:

  exp/<dataset>/<expID>/model_<epoch>.npz, model_final.npz  the network as
      the JAX package's `.npz` param tree, which its `load_kpd_checkpoint`
      and the port's read (PyraNet's batch norm calibrated first);
  exp/<dataset>/<expID>/optimizer.npz   the optimizer state in the JAX
      trainer's layout (optax key paths), which both trainers' --Continue
      read (the port also reads its older "<slot>/<parameter name>"
      files);
  exp/<dataset>/<expID>/option.json     the flags;
  tensorboard/<dataset>/<expID>/metrics.jsonl  Train/Loss and Train/Acc
      per step, Valid/Loss and Valid/Acc per validated epoch (and
      tensorboardX events where tensorboardX is installed).

The epoch loop (`train_kpd`) takes any object whose `.epoch()` yields
dicts of imgs [B,H,W,3] RGB in [0,1], bndbox [B,4] and part [B,K,2]
(numpy arrays or tensors): `data/annot.KPDTrainDataset` here, frames made
in memory in `chip_smoke.py`.  It runs on `--device` (default cuda).

`--n_devices N` trains data-parallel on N ranks (`parallel/launch`: N
CUDA devices under NCCL, or N CPU processes under gloo with `--device
cpu`).  As in the JAX trainer, `--trainBatch` is the global batch: each
rank trains on its trainBatch / N rows, draws the global batch's random
augmentation and keeps its rows, and holds the same network, with the
gradients averaged and the batch norms' statistics taken over all ranks
(`kpd_train.make_train_step`).  Every rank reads --loadModel and
--Continue; rank 0 alone prints and writes the logs and checkpoints.

Example:
  python -m betapose_tpu_torch.train.train_kpd_main --expID seq1 \\
      --nClasses 50 --optMethod adam --trainBatch 28 \\
      --annot_dir ./data/01 --img_dir ./data/01
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from betapose_tpu_torch.core import checkpoint as ckpt
from betapose_tpu_torch.core.config import make_parser
from betapose_tpu_torch.core.device import resolve_device
from betapose_tpu_torch.data.annot import KPDTrainDataset
from betapose_tpu_torch.models import hgprm
from betapose_tpu_torch.models import kpd as kpd_mod
from betapose_tpu_torch.train import kpd_train
from betapose_tpu_torch.parallel import collectives as coll
from betapose_tpu_torch.parallel import launch
from betapose_tpu_torch.parallel import mesh as mesh_mod
from betapose_tpu_torch.parallel.layers import set_batch_norm_group
from betapose_tpu_torch.train.augment import (AugmentConfig, augment_batch,
                                              draw_random)


class MetricsLogger:
    """tensorboardX if available, always a metrics.jsonl."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")
        self.f = open(self.path, "a")
        self.tb = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        self.tb = SummaryWriter(logdir)

    def scalar(self, tag, value, step):
        self.f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        if self.tb is not None:
            self.tb.add_scalar(tag, float(value), step)

    def flush(self):
        self.f.flush()

    def close(self):
        self.f.close()
        if self.tb is not None:
            self.tb.close()


def add_train_args(parser):
    parser.add_argument("--annot_dir", default="./data/05", type=str,
                        help="directory holding annot_{train,eval}.h5")
    parser.add_argument("--img_dir", default=None, type=str,
                        help="image root (default: annot_dir)")
    parser.add_argument("--valid_every", default=5, type=int)
    parser.add_argument("--n_devices", default=None, type=int,
                        help="data-parallel ranks (CUDA devices, or CPU "
                        "processes with --device cpu); --trainBatch is the "
                        "global batch and must split evenly")
    parser.add_argument("--exp_root", default="exp", type=str)
    parser.add_argument("--tb_root", default="tensorboard", type=str)
    parser.add_argument("--trainPrecision", default=None, type=str,
                        choices=["bfloat16", "tensorfloat32", "float32"],
                        help="conv mode of the train step (default: "
                        "kpd_train.DEFAULT_TRAIN_PRECISION); activations/"
                        "BN/loss/optimizer stay f32 in every mode")
    parser.add_argument("--symPerms", default=None, type=str,
                        help="symmetric-object training: .npy [M,K] (or "
                        "text, one comma-separated row per symmetry "
                        "element) of keypoint-channel permutations; the "
                        "loss becomes the per-sample min over symmetry "
                        "modes (kpd_train.make_loss_fn sym_perms)")
    return parser


def load_sym_perms(path, n_classes):
    """Load channel permutations for the symmetry-aware loss: .npy [M,K]
    or text rows of comma-separated ints.  Each row must be a permutation
    of range(n_classes)."""
    if path.endswith(".npy"):
        arr = np.load(path)
        rows = np.atleast_2d(np.asarray(arr, np.int64))
    else:
        with open(path) as f:
            rows = np.asarray(
                [[int(v) for v in line.replace(",", " ").split()]
                 for line in f if line.strip()], np.int64)
    perms = []
    for row in rows:
        if sorted(row.tolist()) != list(range(n_classes)):
            raise ValueError(
                f"--symPerms row {row.tolist()} is not a permutation of "
                f"range({n_classes})")
        perms.append(row.astype(np.int32))
    return tuple(perms)


@dataclasses.dataclass
class Network:
    """The network a run trains, and how it is made ready for inference
    and loaded from a checkpoint."""
    model: torch.nn.Module
    net_kwargs: dict

    @property
    def is_hgprm(self):
        return isinstance(self.model, hgprm.PyraNet)

    def prepare_infer(self, inps):
        """PyraNet trains with batch statistics and leaves its running
        ones, so they are calibrated on a batch before any inference-mode
        use (validation, snapshots); FastPose rolls its own."""
        if self.is_hgprm:
            return hgprm.calibrate_bn(self.model, inps)
        return self.model

    def load(self, path):
        """Load a checkpoint into the model: FastPose from a torch .pkl/.pth
        or an .npz, PyraNet from the .npz of this trainer (the reference
        never trained it, so it has no torch checkpoint contract)."""
        if self.is_hgprm and not path.endswith(".npz"):
            raise ValueError(f"hgPRM checkpoint {path}: .npz only")
        src = ckpt.load_kpd_checkpoint(path, **self.net_kwargs)
        self.model.load_state_dict(src.state_dict())

    def to_tree(self, state_dict):
        """The JAX param tree of a `state_dict` of this network."""
        if self.is_hgprm:
            kw = self.net_kwargs
            return hgprm.params_from_state_dict(
                state_dict, kw["n_stack"], kw["n_residual"],
                kw["cardinality"])
        return kpd_mod.params_from_state_dict(state_dict)

    def from_tree(self, tree):
        """The inverse of `to_tree`."""
        mod = hgprm if self.is_hgprm else kpd_mod
        return mod.state_dict_from_jax(tree)


def build_network(args) -> Network:
    """The network of --netType, seeded as the JAX trainer's init is (key
    0); anything but resnet50, resnet101 or hgPRM raises."""
    gen = torch.Generator().manual_seed(0)
    if args.netType == "hgPRM":
        kw = dict(n_feats=args.nFeats, n_stack=args.nStack,
                  n_residual=args.nResidual, base_width=args.baseWidth,
                  cardinality=args.cardinality)
        model = hgprm.PyraNet(args.nClasses, generator=gen, **kw)
        return Network(model, dict(n_classes=args.nClasses, arch="hgPRM",
                                   **kw))
    if args.netType in ("resnet50", "resnet101"):
        model = kpd_mod.FastPose(args.nClasses, args.netType, gen)
        return Network(model, dict(n_classes=args.nClasses,
                                   arch=args.netType))
    raise ValueError(
        f"unsupported --netType {args.netType!r}: expected resnet50, "
        "resnet101, or hgPRM")


@dataclasses.dataclass
class TrainResult:
    model: torch.nn.Module     # the trained module, in train mode's state
    final: torch.nn.Module     # what model_final.npz holds
    history: list              # (loss, acc) per step
    exp_dir: str


def _to_device(batch_host, device):
    return [torch.as_tensor(batch_host[k]).to(device)
            for k in ("imgs", "bndbox", "part")]


def start_state(args, net: Network, exp_dir: str):
    """(optimizer, first epoch) of a run: --loadModel's weights, then, with
    --Continue, the optimizer state and the latest snapshot of the
    experiment directory (reference train.py:114-116).  The state may be
    the JAX trainer's or the port's; it must be whole (a missing or an
    unknown key raises)."""
    start_epoch = args.epoch
    if args.loadModel:
        net.load(args.loadModel)
        print(f"Loading model from {args.loadModel}")
    model = net.model
    optimizer = kpd_train.make_optimizer(
        model.parameters(), args.optMethod, args.LR, args.momentum,
        args.weightDecay)
    opt_ckpt = os.path.join(exp_dir, "optimizer.npz")
    if args.Continue and os.path.exists(opt_ckpt):
        with np.load(opt_ckpt) as arrays:
            optimizer.load_named_state(arrays, model, net.to_tree,
                                       net.from_tree)
        epochs = sorted(
            int(f[6:-4]) for f in os.listdir(exp_dir)
            if f.startswith("model_") and f.endswith(".npz")
            and f[6:-4].isdigit())
        if epochs:
            net.load(os.path.join(exp_dir, f"model_{epochs[-1]}.npz"))
            start_epoch = epochs[-1] + 1
            print(f"Continuing from epoch {start_epoch}")
    return optimizer, start_epoch


def train_kpd(args, train_ds, valid_ds=None, net: Network | None = None,
              timer=None, mesh=None) -> TrainResult:
    """Train for epochs args.epoch..args.nEpochs-1 on `train_ds`, with the
    JAX trainer's --loadModel and --Continue rules, validation every
    --valid_every epochs (when `valid_ds` is given), snapshots every
    --snapshot epochs and model_final.npz at the end.  `timer`, when
    given, is called with "start", "augmented" and "stepped" around each
    step's augmentation and train step.  `mesh` (a `parallel/mesh`
    mesh, inside `parallel/launch.run_ranks`): train data-parallel over
    its `data` axis, `train_ds` yielding the global batches."""
    net = net or build_network(args)
    device = resolve_device(args.device)
    model = net.model.to(device)
    group = mesh_mod.axis_group(mesh, "data") if mesh is not None else None
    lead = mesh is None or dist.get_rank() == 0

    exp_dir = os.path.join(args.exp_root, args.dataset, args.expID)
    os.makedirs(exp_dir, exist_ok=True)
    log = (MetricsLogger(os.path.join(args.tb_root, args.dataset,
                                      args.expID)) if lead else None)

    optimizer, start_epoch = start_state(args, net, exp_dir)
    opt_ckpt = os.path.join(exp_dir, "optimizer.npz")
    if mesh is not None:
        mesh_mod.replicate(mesh, model)
        set_batch_norm_group(model, group)
    precision = args.trainPrecision or kpd_train.DEFAULT_TRAIN_PRECISION
    sym_perms = (load_sym_perms(args.symPerms, args.nClasses)
                 if args.symPerms else None)
    train_step = kpd_train.make_train_step(
        model, optimizer, args.outputResH, precision, sym_perms, group)
    eval_step = kpd_train.make_eval_step(args.outputResH, sym_perms)
    aug_cfg = AugmentConfig(
        inp_h=args.inputResH, inp_w=args.inputResW,
        out_h=args.outputResH, out_w=args.outputResW,
        scale_min=0.2, scale_max=0.3, rotate=args.rotate,
        hm_gauss=args.hmGauss, add_dpg=bool(args.addDPG), train=True)
    valid_cfg = dataclasses.replace(aug_cfg, train=False)
    gen = torch.Generator(device=device).manual_seed(42)

    history = []
    best_epoch, best_acc = 0, -1.0
    it = args.trainIters
    last_inps = None
    for epoch in range(start_epoch, args.nEpochs):
        t0 = time.time()
        ep_loss, ep_acc, n_it = 0.0, 0.0, 0
        for batch_host in train_ds.epoch():
            if timer:
                timer("start")
            batch = _augment(batch_host, aug_cfg, gen, device, mesh)
            if timer:
                timer("augmented")
            m = train_step(batch)
            if timer:
                timer("stepped")
            it += 1
            n_it += 1
            loss, acc = float(m["loss"]), float(m["acc"])
            history.append((loss, acc))
            ep_loss += loss
            ep_acc += acc
            if lead:
                log.scalar("Train/Loss", loss, it)
                log.scalar("Train/Acc", acc, it)
            last_inps = batch["inps"]
        ep_loss /= max(n_it, 1)
        ep_acc /= max(n_it, 1)
        if lead:
            print(f"Epoch {epoch} | loss {ep_loss:.6f} | acc {ep_acc:.4f} "
                  f"| {time.time() - t0:.1f}s")
            log.flush()

        do_valid = valid_ds is not None and epoch % args.valid_every == 0
        do_snap = bool(args.snapshot) and epoch % args.snapshot == 0
        infer = model
        if (do_valid or do_snap) and last_inps is not None:
            infer = net.prepare_infer(_global_rows(last_inps, group))
        if do_valid:
            # every rank validates the whole set: the draws keep every
            # rank's generator in step
            v_loss, v_acc, nv = 0.0, 0.0, 0
            for batch_host in valid_ds.epoch():
                batch = _augment(batch_host, valid_cfg, gen, device)
                m = eval_step(infer, batch)
                v_loss += float(m["loss"])
                v_acc += float(m["acc"])
                nv += 1
            v_loss /= max(nv, 1)
            v_acc /= max(nv, 1)
            if lead:
                print(f"Valid epoch {epoch} | loss {v_loss:.6f} | acc "
                      f"{v_acc:.4f}")
                log.scalar("Valid/Loss", v_loss, epoch)
                log.scalar("Valid/Acc", v_acc, epoch)
            if v_acc > best_acc:
                best_acc, best_epoch = v_acc, epoch
        if do_snap:
            _barrier(mesh)
        if do_snap and lead:
            ckpt.save_kpd_npz(os.path.join(exp_dir, f"model_{epoch}.npz"),
                              infer)
            np.savez(opt_ckpt, **optimizer.jax_named_state(model,
                                                           net.to_tree))
            with open(os.path.join(exp_dir, "option.json"), "w") as f:
                json.dump(vars(args), f, default=str)
    final = (net.prepare_infer(_global_rows(last_inps, group))
             if last_inps is not None else model)
    _barrier(mesh)
    if lead:
        print(f"Best epoch: {best_epoch}, acc {best_acc:.4f}")
        log.close()
        ckpt.save_kpd_npz(os.path.join(exp_dir, "model_final.npz"), final)
    return TrainResult(model, final, history, exp_dir)


def _augment(batch_host, cfg, gen, device, mesh=None):
    """The augmented batch: the draws of the whole batch from `gen`, and,
    with `mesh`, this rank's rows of the batch and of its draws."""
    imgs, bndbox, part = _to_device(batch_host, device)
    draws = draw_random(imgs.shape[0], cfg, gen)
    if mesh is not None:
        imgs, bndbox, part, draws = mesh_mod.shard_batch(
            mesh, (imgs, bndbox, part, draws))
    return augment_batch(imgs, bndbox, part, cfg, draws=draws)


def _global_rows(x, group):
    """x with every rank's rows of the batch, in rank order."""
    return coll.gather(x, 0, group)


def _barrier(mesh):
    if mesh is not None:
        dist.barrier()


def parse_args(argv=None):
    parser = add_train_args(make_parser("Betapose (PyTorch) KPD training"))
    return parser.parse_args(argv)


def _datasets(args):
    img_dir = args.img_dir or args.annot_dir
    train_ds = KPDTrainDataset(
        os.path.join(args.annot_dir, "annot_train.h5"),
        os.path.join(img_dir, "train"), args.trainBatch, shuffle=True)
    try:
        valid_ds = KPDTrainDataset(
            os.path.join(args.annot_dir, "annot_eval.h5"),
            os.path.join(img_dir, "eval"), args.validBatch, shuffle=False)
    except OSError:
        valid_ds = None
    return train_ds, valid_ds


def _train_rank(args):
    """One rank of `--n_devices N`: rank 0 returns the final network's
    state_dict as numpy arrays."""
    net = build_network(args)
    mesh = mesh_mod.make_mesh(args.n_devices)
    res = train_kpd(args, *_datasets(args), net, mesh=mesh)
    return {k: v.detach().cpu().numpy()
            for k, v in res.final.state_dict().items()}


def main(argv=None):
    args = parse_args(argv)
    n = args.n_devices or 1
    if n < 1 or args.trainBatch % n:
        raise ValueError(
            f"--n_devices {args.n_devices}: the global batch --trainBatch "
            f"{args.trainBatch} must split evenly over the devices")
    net = build_network(args)       # fail fast, before any dataset IO
    if n == 1:
        return train_kpd(args, *_datasets(args), net).final
    state = launch.run_ranks(_train_rank, n, args.device, args)
    net.model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
    return net.model.eval()


if __name__ == "__main__":
    main()
