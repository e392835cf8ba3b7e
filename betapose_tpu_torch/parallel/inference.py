"""The pose pipeline sharded over a device mesh.

Counterpart of `betapose_tpu/parallel/inference.py`.  SPMD, as a JAX
program over a mesh is: every rank builds the `ShardedPosePipeline` from
the same networks and calls it with the same global frames, and every
rank gets the global outputs back, as a JAX caller gets a global array.

- data (`data` axis): each rank runs the fused step (`eval/pipeline`) on
  its rows of the batch, the decode kernel included; the outputs are
  all-gathered over `data`.
- tensor (`model` axis, model_parallel > 1): every conv and linear layer
  whose output channels divide the axis is column-parallel
  (`parallel/layers.ColumnParallel`); each rank keeps only its slice of
  their weights.
- spatial (`space` axis, spatial_parallel > 1): every rank of the axis
  takes the whole frames for the resize and the crop, whose windows reach
  across any band, and YOLO and FastPose split their maps' rows over the
  axis (`parallel/spatial.split_rows`), with halo exchange; the heads and
  heatmaps are gathered before the best box and the decode.  PyraNet
  (net_type "hgPRM") runs whole on every rank of `space`: its pyramid
  pools at fractional scales read the whole map.

The host pose-NMS mode (`det_capacity > 1` with `host_pose_nms`) breaks
the fused step and raises, as in the JAX package.  The s2d stem
(`s2d_stem=True`) runs with data parallelism alone: its rewrite reads
the first two layers' whole weights from the unsplit darknet.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from betapose_tpu_torch.core.device import resolve_device
from betapose_tpu_torch.eval.pipeline import (PipelineConfig, PosePipeline,
                                              check_config, make_det_stage,
                                              make_multi_post_stage,
                                              make_pose_stage,
                                              make_post_stage)
from betapose_tpu_torch.parallel import collectives as coll
from betapose_tpu_torch.parallel import launch
from betapose_tpu_torch.parallel import mesh as mesh_mod
from betapose_tpu_torch.parallel.layers import tensor_parallel
from betapose_tpu_torch.parallel.spatial import Space, split_rows


class ShardedPosePipeline:
    """`PosePipeline`'s step over a mesh.  The global batch must divide by
    the mesh's `data` size.  yolo, kpd: the networks as `PosePipeline`
    takes them (batch norms folded).  mesh: a `mesh.make_mesh` mesh, or
    one is made from n_devices, model_parallel and spatial_parallel.
    device=None means the rank's CUDA device; the CPU runs when asked
    for, under gloo."""

    def __init__(self, yolo, kpd, kp3d, cam_K,
                 cfg: PipelineConfig | None = None, mesh=None,
                 n_devices=None, model_parallel: int = 1,
                 spatial_parallel: int = 1, device=None):
        self.cfg = cfg or PipelineConfig()
        if self.cfg.det_capacity > 1 and self.cfg.host_pose_nms:
            raise ValueError(
                "ShardedPosePipeline runs the fused step; the reference's "
                "host clustering (host_pose_nms=True) breaks it: use "
                "PosePipeline, or the device pose-NMS (host_pose_nms="
                "False)")
        check_config(self.cfg)
        self.device = resolve_device(device)
        if dist.get_backend() != launch.backend_for(self.device.type):
            raise ValueError(
                f"device {self.device} under the {dist.get_backend()} "
                "backend: CUDA ranks run NCCL, CPU ranks gloo")
        self.mesh = mesh or mesh_mod.make_mesh(
            n_devices, model_parallel, spatial_parallel,
            device_type=self.device.type)
        if self.cfg.s2d_stem and self.mesh.ndim > 1:
            raise ValueError(
                "the s2d stem runs with data parallelism alone: its "
                "rewrite reads the whole darknet's first two layers")
        pipe = PosePipeline(yolo, kpd, kp3d, cam_K, self.cfg,
                            device=self.device)
        group = mesh_mod.axis_group(self.mesh, "model")
        self.yolo = tensor_parallel(pipe.yolo, group)
        self.kpd = tensor_parallel(pipe.kpd, group)
        self.kp3d, self.cam_K = pipe.kp3d, pipe.cam_K
        del pipe
        space = Space(mesh_mod.axis_group(self.mesh, "space"))
        if space.n > 1:
            self.yolo = split_rows(self.yolo, space)
            if self.cfg.net_type != "hgPRM":
                self.kpd = split_rows(self.kpd, space)
        self.det_stage = make_det_stage(self.cfg)
        self.pose_stage = make_pose_stage(self.cfg)
        self.post_stage = (make_multi_post_stage(self.cfg)
                           if self.cfg.det_capacity > 1
                           else make_post_stage(self.cfg))
        self.data = mesh_mod.axis_group(self.mesh, "data")

    @torch.inference_mode()
    def __call__(self, frames_u8):
        """frames_u8: the global [B, H, W, 3] RGB uint8 batch (numpy or a
        tensor), the same on every rank.  Returns the global per-frame
        outputs, on this rank's device."""
        frames = mesh_mod.shard_batch(self.mesh, frames_u8)
        frames = torch.as_tensor(frames).to(self.device)
        det = self.det_stage(self.yolo, frames)
        hm = self.pose_stage(self.kpd, det["crops"])
        out = self.post_stage(hm, det, self.kp3d, self.cam_K)

        def gather(v):
            if v.dtype == torch.bool:
                return gather(v.to(torch.uint8)).bool()
            return coll.gather(v, 0, self.data)

        return {k: gather(v) for k, v in out.items()}
