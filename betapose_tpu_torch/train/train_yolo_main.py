"""The YOLO trainer.

Counterpart of `betapose_tpu/train/train_yolo_main.py` (darknet's
`train_detector`, `detector.c:38-232`): the .data/.cfg/.weights triplet,
resume from .weights with its `seen` (or from 0 with `clear`), the LR
schedule fast-forwarded to seen // batch, crop-jitter, flip and HSV
augmentation on the device, darknet .weights snapshots into the .data
file's backup directory every `snapshot_every` iterations and
`<cfg>_final.weights` at the end, and the NaN loss guard (`detector.c:197`
resets the running average).

- The batch is the cfg's `batch` (`subdivisions` is ignored, as the JAX
  package ignores it).
- The images and resolutions are drawn from `np.random.default_rng(0)` as
  the JAX trainer draws them, so both train on the same images at the same
  resolutions; the augmentation draws come from a `torch.Generator`.
- Random-resize training (`detector.c:131-161`) is the JAX package's
  static bucket set (`resolution_buckets`), one bucket drawn every 10
  iterations when the cfg's [net] sets random.
- Frames are decoded on 8 threads (cv2), cross to the card as uint8 and
  are divided by 255 there.
- `device=None` means CUDA (`core/device.resolve_device`).
- `n_devices=N` (darknet's `-gpus 0,1,...`) trains data-parallel on N
  ranks (`parallel/launch`; N CPU processes under gloo with
  `device="cpu"`).  The batch stays the cfg's global one, as in the JAX
  trainer: every rank draws the same resolution and image indices from
  the host rng, decodes only its rows, draws the global batch's
  augmentation and keeps its rows; the gradients are summed
  (`yolo_train.make_train_step`) and the batch norms take the global
  statistics.  `seen` and the LR schedule count global images; rank 0
  alone prints and writes the `.weights` snapshots.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from betapose_tpu_torch.core.device import resolve_device
from betapose_tpu_torch.data.loader import imread_rgb
from betapose_tpu_torch.models import yolov3 as yolo_mod
from betapose_tpu_torch.parallel import launch
from betapose_tpu_torch.parallel import mesh as mesh_mod
from betapose_tpu_torch.parallel.layers import set_batch_norm_group
from betapose_tpu_torch.train import yolo_train


def _net_cfg_options(spec):
    net = spec.net_info
    get = lambda k, d: type(d)(net.get(k, d))  # noqa: E731
    steps = tuple(int(s) for s in
                  str(net.get("steps", "3000,5000")).split(","))
    scales = tuple(float(s) for s in
                   str(net.get("scales", ".1,.1")).split(","))
    return yolo_train.YoloTrainConfig(
        lr=get("learning_rate", 1e-3),
        burn_in=get("burn_in", 1000),
        steps=steps, scales=scales,
        momentum=get("momentum", 0.9),
        decay=get("decay", 5e-4),
        max_batches=get("max_batches", 6100),
        jitter=0.3,
        hue=get("hue", 0.1),
        saturation=get("saturation", 1.5),
        exposure=get("exposure", 1.5),
    )


def resolution_buckets(base: int, span: float = 0.4, n: int = 3):
    """Static analog of darknet random-resize: n resolutions within
    +-span of base, snapped to /32."""
    lo = int(base * (1 - span)) // 32 * 32
    hi = int(base * (1 + span)) // 32 * 32
    if n == 1:
        return [base]
    step = max(32, (hi - lo) // (n - 1) // 32 * 32)
    buckets = sorted({min(hi, lo + i * step) for i in range(n)} | {base})
    return list(buckets)


def train_from_data_cfg(data_path, cfg_path, weights_path=None,
                        clear=False, n_devices=None, batch=None,
                        snapshot_every=100, log_every=1,
                        resize_buckets=3, max_batches=None,
                        precision=None, device=None, timer=None, mesh=None):
    """Train the cfg's network on the .data file's train list; returns the
    trained `Darknet`.  `timer`, when given, is called with "start",
    "loaded", "augmented" and "stepped" at those points of each
    iteration (the frames on the card, the augmented batch, the update).
    n_devices > 1 runs that many ranks, each calling this with its
    `mesh`."""
    from betapose_tpu_torch.tools.darknet_cli import read_data_cfg

    kw = dict(weights_path=weights_path, clear=clear, batch=batch,
              snapshot_every=snapshot_every, log_every=log_every,
              resize_buckets=resize_buckets, max_batches=max_batches,
              precision=precision, device=device)
    if (n_devices or 1) > 1 and mesh is None:
        state = launch.run_ranks(_train_rank, n_devices, device, data_path,
                                 cfg_path, n_devices, kw)
        with open(cfg_path) as f:
            spec = yolo_mod.build_spec(f.read())
        model = yolo_mod.Darknet(spec, int(spec.net_info.get("width", 416)))
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
        return model.eval()
    group = mesh_mod.axis_group(mesh, "data") if mesh is not None else None
    lead = mesh is None or dist.get_rank() == 0
    dev = resolve_device(device)
    opts = read_data_cfg(data_path)
    backup = opts.get("backup", "backup")
    os.makedirs(backup, exist_ok=True)
    with open(cfg_path) as f:
        cfg_text = f.read()
    spec = yolo_mod.build_spec(cfg_text)
    tcfg = _net_cfg_options(spec)
    if max_batches is not None:
        tcfg.max_batches = max_batches
    net = spec.net_info
    base_reso = int(net.get("width", 416))
    global_batch = batch or int(net.get("batch", 64))
    base_name = os.path.splitext(os.path.basename(cfg_path))[0]

    seen = 0
    if weights_path and os.path.exists(weights_path):
        # a truncated file (a pretrained backbone) leaves the other
        # layers at the seeded init
        model, header = yolo_mod.load_darknet_weights(
            spec, weights_path, base_reso,
            generator=torch.Generator().manual_seed(0))
        seen = 0 if clear else int(header[3])
        print(f"Resuming from {weights_path} (seen={seen})")
    else:
        model = yolo_mod.Darknet(spec, base_reso,
                                 torch.Generator().manual_seed(0))
    model = model.to(dev)

    if mesh is not None:
        if global_batch % mesh_mod.axis_size(mesh, "data"):
            raise ValueError(f"batch {global_batch} does not split over "
                             f"{n_devices} devices")
        mesh_mod.replicate(mesh, model)
        set_batch_norm_group(model, group)
    optimizer = yolo_train.make_optimizer(model, tcfg)
    yolo_train.fast_forward_opt_state(optimizer, seen // global_batch)

    buckets = resolution_buckets(base_reso, n=resize_buckets) \
        if int(net.get("random", 0)) else [base_reso]
    precision = precision or yolo_train.DEFAULT_TRAIN_PRECISION
    steps_by_reso = {
        r: yolo_train.make_train_step(model, optimizer, r, r, precision,
                                      group)
        for r in buckets}
    say = print if lead else (lambda *a, **k: None)
    say(f"resolution buckets: {buckets}")

    paths, truths = yolo_train.load_darknet_labels(
        opts["train"], max_boxes=tcfg.max_boxes)
    say(f"{len(paths)} training images")

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    start_iter = seen // global_batch
    avg_loss = -1.0
    cur_reso = base_reso

    def mark(name):
        if timer:
            timer(name)

    with cf.ThreadPoolExecutor(8) as pool:
        for it in range(start_iter, tcfg.max_batches):
            if it % 10 == 0 and len(buckets) > 1:
                cur_reso = buckets[rng.integers(len(buckets))]
            idxs = rng.integers(0, len(paths), global_batch)
            mark("start")
            if mesh is not None:   # this rank's rows
                idxs = mesh_mod.shard_batch(mesh, idxs)
            imgs = torch.from_numpy(np.stack(list(pool.map(
                lambda i: imread_rgb(paths[i]), idxs)))).to(dev)
            truths_dev = torch.from_numpy(truths[idxs]).to(dev)
            mark("loaded")
            # the global batch's draws, this rank's rows of them
            draws = yolo_train.draw_random(global_batch, imgs.shape[1],
                                           imgs.shape[2], tcfg, gen)
            if mesh is not None:
                draws = mesh_mod.shard_batch(mesh, draws)
            aug_imgs, aug_truths = yolo_train.augment_detection_batch(
                imgs.float() / 255.0, truths_dev, tcfg, cur_reso, cur_reso,
                draws=draws)
            mark("augmented")
            t0 = time.time()
            m = steps_by_reso[cur_reso](aug_imgs, aug_truths)
            mark("stepped")
            loss = float(m["loss"])
            if not np.isfinite(loss):
                # darknet NaN guard (detector.c:197): reset the average
                avg_loss = -1.0
                say(f"{it}: loss is NaN — skipping average update")
            else:
                avg_loss = (loss if avg_loss < 0
                            else avg_loss * 0.9 + loss * 0.1)
            if it % log_every == 0:
                say(f"{it}: {loss:.6f}, {avg_loss:.6f} avg, "
                    f"reso {cur_reso}, {time.time() - t0:.3f} s")
            if snapshot_every and it > 0 and it % snapshot_every == 0:
                out = os.path.join(backup, f"{base_name}_{it}.weights")
                _save(model, out, (it + 1) * global_batch, mesh, lead)
                say(f"Saving weights to {out}")
    out = os.path.join(backup, f"{base_name}_final.weights")
    _save(model, out, tcfg.max_batches * global_batch, mesh, lead)
    say(f"Saving weights to {out}")
    return model.eval()


def _save(model, path, seen, mesh, lead):
    """Rank 0 writes the snapshot, once every rank has finished the
    step."""
    if mesh is not None:
        dist.barrier()
    if lead:
        yolo_mod.save_darknet_weights(model, path, seen=seen)


def _train_rank(data_path, cfg_path, n_devices, kw):
    """One rank of n_devices > 1: rank 0 returns the trained network's
    state_dict as numpy arrays."""
    model = train_from_data_cfg(data_path, cfg_path, n_devices=n_devices,
                                mesh=mesh_mod.make_mesh(n_devices), **kw)
    return {k: v.detach().cpu().numpy()
            for k, v in model.state_dict().items()}


if __name__ == "__main__":
    import sys
    train_from_data_cfg(*sys.argv[1:4])
